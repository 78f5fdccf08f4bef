"""VGG16's fc6 / fc7 stack: its bound (`benchmark/bounds/dense.py`, from
each call's rows) summed over the window's calls, over the device time of
every launch made inside those calls (the two products, the ReLUs and the
dropout draws). The forward only: the backward's products run in
autograd, outside any op range, and are not in it."""

OP = "vgg_fc"


def read(view):
    t = view["summary"].op_device_s.get(OP)
    if not t or OP not in view["bounds"]:
        return None
    return 100.0 * view["bounds"][OP] / t
