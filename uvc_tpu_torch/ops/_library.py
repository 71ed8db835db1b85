"""The serving kernels as operators of the ``uvc_tpu_torch`` namespace.

A wrapper that calls its kernel through ``ctypes`` is opaque to tracing:
``torch.export`` would record the plain version's decomposition or fail
on the raw pointers.  ``define`` makes a kernel a dispatcher operator
instead, ``torch.ops.uvc_tpu_torch.<name>``, with three implementations:

* ``CUDA``: the wrapper's kernel path (its checks, scratch and launch);
* ``CPU``: the plain PyTorch version;
* the fake (meta) implementation, which gives the outputs' shapes, dtypes
  and device from the inputs' alone, so that ``torch.export`` and
  ``torch.library.opcheck`` trace the operator without running it.

Any other device has no implementation: the public wrappers refuse it
before they reach the operator.  The operators are defined through
``torch.library.Library``, the dispatcher's own route, which adds less
host time a call than ``torch.library.custom_op``'s Python layer.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "uvc_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, *, cpu: Callable, cuda: Callable,
           fake: Callable):
    """Define the operator of ``schema`` (``"name(Tensor x, ...) ->
    Tensor"``) with its CPU, CUDA and fake implementations; returns its
    overload, ``torch.ops.uvc_tpu_torch.<name>.default``."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
