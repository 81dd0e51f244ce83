"""Seconds a finished pipeline (grow, export, build, pull test): the
window's host time over the pipelines it completed."""


def read(view):
    if view.kind != "pipeline" or not view.unit_s:
        return None
    return view.window_s / len(view.unit_s)
