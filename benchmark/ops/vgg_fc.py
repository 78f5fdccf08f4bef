"""VGG16's fc6 and fc7 (each with its ReLU and dropout), timed at the
program's entry `models/vgg.py::fc_stack`; the bound from the call's rows
and the two layers' widths (`benchmark/bounds/dense.py`).

A program from before `fc_stack` (the stack inside `VGG16.tail`) has no
entry to time: the op then wraps `absent` below, which nothing calls, so
the metric that reads the op reads nothing."""

import importlib

from benchmark.bounds import dense

PROGRAM = ("lang2seg_tpu_torch.models.vgg", "fc_stack")


def absent(*args, **kwargs):
    raise RuntimeError("not an entry of the program")


ENTRY = (PROGRAM if hasattr(importlib.import_module(PROGRAM[0]), PROGRAM[1])
         else ("benchmark.ops.vgg_fc", "absent"))


def keep(args, kwargs, out):
    """(rows, in, out) of fc6 and of fc7."""
    flat, classifier = args[:2]
    return tuple((flat.shape[0], fc.in_features, fc.out_features)
                 for fc in (classifier[0], classifier[3]))


def bound_s(rec) -> float:
    return dense.bound_s(rec)
