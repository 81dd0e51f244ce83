"""Seconds a finished pull test: the window's host time over the pull
tests it completed."""


def read(view):
    if view.kind != "pull_test" or not view.unit_s:
        return None
    return view.window_s / len(view.unit_s)
