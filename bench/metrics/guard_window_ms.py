"""``guard_window_ms``: the host clock around each call of Guard's step
hook that scored a frame (``GuardSession.observe`` through the detector
and K1, its flagged rows read back), averaged over the window's."""


def read(ctx):
    s = ctx["guard_s"]
    return 1e3 * sum(s) / len(s) if s else None
