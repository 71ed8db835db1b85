"""The benchmark of ``uvc_tpu_torch`` on the H100 (see README.md)."""
