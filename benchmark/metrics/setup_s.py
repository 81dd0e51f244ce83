"""Set-up seconds: process start to the first timed unit (CUDA start-up,
the kernel library's load, the networks, ``build_model``, one warm-up
unit a network)."""


def read(view):
    return view.setup_s
