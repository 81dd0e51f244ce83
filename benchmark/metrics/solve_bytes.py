"""The least bytes one displacement solve must move, whatever implements
it: its problem's inputs read once and its solution written once.

Inputs: the node coordinates (3N floats), the connectivity (2E indices of
4 bytes, enough for any mesh the card holds), the active mask (E bytes)
and the anchored mask (N bytes), the grips (two masks of N bytes and the
two grip displacements, floats), the start vector x0 (3N floats). Output:
x (3N floats). Floats are the configuration's dtype. Nothing of a
solver's own state (a preconditioner's factors, its tables, iterations)
counts, so the share reads the same work whatever the solver."""


def problem_bytes(n_nodes: int, n_elems: int, float_bytes: int) -> int:
    coords = 3 * n_nodes * float_bytes
    conn = 2 * n_elems * 4
    masks = n_elems + n_nodes + 2 * n_nodes
    grips = 2 * float_bytes
    vectors = 2 * 3 * n_nodes * float_bytes      # x0 read, x written
    return coords + conn + masks + grips + vectors


def roofline_pct(view, kind: str):
    """The solve spans' least time over their device time, in %, or None
    (another kind, no trace, no peak for the card, no device time)."""
    t = view.trace
    if view.kind != kind or t is None or view.peaks is None:
        return None
    dev = t.device_s("solve_displacement")
    if dev <= 0:
        return None
    least = t.count("solve_displacement") * problem_bytes(
        view.n_nodes, view.n_elems, view.float_bytes) \
        / view.peaks["hbm_bytes_s"]
    return 100.0 * least / dev
