"""The port's command line against the JAX package's:

- its parser accepts every option string of every subcommand of
  ``mycelium_tpu.cli.build_parser()`` (and every choice of each), and the
  options it has beyond them are the ones named here;
- a tiny ``grow --snapshots png`` and ``fea`` write the PNG files the JAX
  CLI writes on the same command line (the growth summary, a snapshot a
  step, the force-displacement curve, a frame a ramp step), and
  ``plot-snapshots`` / ``plot-fea`` on a results directory of the CSV
  contract write the files the JAX CLI's write on a copy of it, pixel for
  pixel the same (the port reads the records with numpy, the JAX CLI with
  pandas).
"""

import os
import shutil

import matplotlib.image as mpimg
import numpy as np

from mycelium_tpu import cli as jcli
from mycelium_tpu_torch import cli as tcli

# The port's options that the JAX CLI does not have: the device, and the
# growth preset, which the JAX CLI does not offer (grow takes it as
# --preset; pipeline, whose --preset is the solver preset in both CLIs,
# as --growth-preset).
PORT_ONLY = {"grow": {"--device", "--preset"},
             "fea": {"--device"},
             "pipeline": {"--device", "--growth-preset"},
             "sweep": {"--device"},
             "plot-snapshots": set(), "plot-fea": set()}


def _subparsers(parser):
    (group,) = [a for a in parser._actions if a.choices
                and isinstance(a.choices, dict)]
    return group.choices


def _options(parser):
    """option string -> its choices (None where it takes any value)."""
    return {s: (tuple(a.choices) if a.choices else None)
            for a in parser._actions for s in a.option_strings}


def test_port_parser_accepts_every_jax_option():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert set(_options(jp)) <= set(_options(tp))        # --distributed
    jsub, tsub = _subparsers(jp), _subparsers(tp)
    assert set(jsub) == set(tsub) == set(PORT_ONLY)
    for name, jparser in jsub.items():
        jopts, topts = _options(jparser), _options(tsub[name])
        missing = set(jopts) - set(topts)
        assert not missing, (name, sorted(missing))
        assert set(topts) - set(jopts) == PORT_ONLY[name], name
        for opt, choices in jopts.items():
            if choices is not None:
                assert set(choices) <= set(topts[opt]), (name, opt)
        # positionals (results_dir) alike
        assert [a.dest for a in jparser._actions if not a.option_strings] \
            == [a.dest for a in tsub[name]._actions if not a.option_strings]


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files
                  if f.endswith(".png"))


def test_cli_writes_the_jax_cli_png_names(tmp_path):
    grow = ["--steps", "2", "--capacity", "2048"]
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    tcli.main(["grow", "--device", "cpu", "--snapshots", "png", "--dir",
               port] + grow)
    tcli.main(["fea", port, "--device", "cpu", "--fea-steps", "2"])
    jcli.main(["grow", "--snapshots", "png", "--dir", ref] + grow)
    jcli.main(["fea", ref, "--fea-steps", "2"])
    names = _pngs(port)
    assert names == _pngs(ref)
    assert names == ["fea_results/fea_step_000.png",
                     "fea_results/fea_step_001.png",
                     "fea_results/force_displacement.png",
                     "mycelium_growth_summary.png",
                     "snapshots/petri_step_0000.png",
                     "snapshots/petri_step_0001.png"]

    # the plot subcommands on the CSV contract, the port's and the JAX
    # CLI's each on its own copy of one results directory
    csvs = str(tmp_path / "csv")
    tcli.main(["grow", "--device", "cpu", "--no-summary-plot", "--dir",
               csvs] + grow)
    tcli.main(["fea", csvs, "--device", "cpu", "--fea-steps", "2",
               "--no-plots"])
    assert _pngs(csvs) == []
    copy = str(tmp_path / "csv_jax")
    shutil.copytree(csvs, copy)
    for cli, d in ((tcli, csvs), (jcli, copy)):
        cli.main(["plot-snapshots", d])
        cli.main(["plot-fea", d])
    names = _pngs(csvs)
    assert names == _pngs(copy)
    assert names == ["fea_results/fea_step_000.png",
                     "fea_results/fea_step_001.png",
                     "fea_results/force_displacement.png",
                     "snapshots/step_0000.png", "snapshots/step_0001.png"]
    for n in names:
        np.testing.assert_array_equal(mpimg.imread(os.path.join(csvs, n)),
                                      mpimg.imread(os.path.join(copy, n)),
                                      err_msg=n)
