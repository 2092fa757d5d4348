"""The benchmark of athenapk_tpu_torch on one NVIDIA H100 (``run.py``)."""
