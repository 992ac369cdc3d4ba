"""Stereo pairs completed in the window over the window's seconds (host clock)."""


def read(rec):
    return rec.pairs / rec.window_s
