"""The share of the traced window in which no kernel, copy or fill runs
on the device, from the union of their intervals on every stream."""


def read(view):
    s = view["summary"]
    if s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
