"""uvc_tpu_torch: the PyTorch / CUDA port of ``uvc_tpu`` for NVIDIA Hopper.

The module layout and function names follow the JAX package, so the
counterpart of ``uvc_tpu/<path>.py`` is ``uvc_tpu_torch/<path>.py``.  The
port imports ``torch`` and ``numpy`` only, never JAX or ``uvc_tpu``.  Its
sublayer kernels are hand-written CUDA C++ for ``sm_90a``
(``uvc_tpu_torch/csrc``), built with ``nvcc`` at first use.

It serves a compressed ViT/DeiT (physical compaction, ``infer.compact``,
and the masked-dense eval step) and trains it: the stage-1 UVC step
(``train.step.build_stage1_step``) with the sublayers' backward kernels.
"""

__version__ = "0.1.0"
