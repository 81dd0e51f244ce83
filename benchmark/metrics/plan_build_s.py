"""Host seconds of ``build_model`` a network, in set-up."""


def read(view):
    b = view.plan_build_s
    return sum(b) / len(b) if b else None
