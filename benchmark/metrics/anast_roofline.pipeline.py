"""K4's share of its roofline, in %: the least time the scans' bytes
(``anast_bytes.py``, counted on the states the window's scans read) take
at the card's HBM bandwidth, over the device time of K4's kernel
(``anast_scan_kernel``) in the traced window."""

KERNEL = "anast_scan_kernel"


def read(view):
    t, b = view.trace, view.counters.get("anast_bytes")
    if view.kind != "pipeline" or t is None or not b or view.peaks is None:
        return None
    dev = sum(s for n, s in t.device_op_s.items() if KERNEL in n)
    if dev <= 0:
        return None
    return 100.0 * sum(b) / view.peaks["hbm_bytes_s"] / dev
