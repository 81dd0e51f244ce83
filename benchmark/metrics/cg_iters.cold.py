"""Mean iterations a cold solve, from each solve's own stats."""


def read(view):
    it = view.counters.get("cg_iters") if view.kind == "cold_solve" \
        else None
    return sum(it) / len(it) if it else None
