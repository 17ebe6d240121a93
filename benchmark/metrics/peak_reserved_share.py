"""The process's peak reserved device memory (``torch.cuda.max_memory_reserved``,
set-up included) over the cap ``configure_torch_from_env`` set for the pod."""


def read(run):
    if not run.peak_reserved or not run.cap_bytes:
        return None
    return 100.0 * run.peak_reserved / run.cap_bytes
