"""Peak device memory over set-up and window (``torch.cuda.
max_memory_allocated``, read before the comparison runs), in GiB; none
where the run had no CUDA device."""


def read(run):
    return run["peak_bytes"] / 2.0 ** 30 if run["peak_bytes"] else None
