"""The examples (counterparts of the repo's ``examples/``): ``python -m
uvc_tpu_torch.examples.learning_demo`` and ``... .serving_demo``, on the
card unless ``--device cpu`` is given."""
