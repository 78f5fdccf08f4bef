"""The ROI crop forward's bound (from each call's own arguments,
`benchmark/bounds/crop.py`) summed over the window's calls, over the
device time of every launch made inside those calls."""

OP = "roi_crop_fwd"


def read(view):
    t = view["summary"].op_device_s.get(OP)
    if not t or OP not in view["bounds"]:
        return None
    return 100.0 * view["bounds"][OP] / t
