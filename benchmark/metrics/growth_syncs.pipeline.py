"""Host syncs a growth step: the program's own ``StepSyncs.per_step`` of
each pipeline's growth, averaged over the traced window's pipelines."""


def read(view):
    s = view.counters.get("growth_syncs") if view.kind == "pipeline" \
        else None
    return sum(s) / len(s) if s else None
