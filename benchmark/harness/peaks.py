"""Published peaks by card name (NVIDIA's data sheet, SXM part, at the
full 700 W power limit): HBM bytes a second, the bound of the solve's
roofline share (``metrics/solve_bytes.py``). A card not named here gets no
roofline share."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12},
}


def peaks(kind: str):
    return PEAKS.get(kind)
