"""Data parallelism across processes (counterpart of ``uvc_tpu/parallel``):
``mesh`` joins the ranks, ``dryrun`` drives one step of each stage across
them."""
