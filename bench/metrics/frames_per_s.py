"""Frames answered inside the window, over the window's seconds."""


def read(run):
    return len(run.completed()) / run.window_s
