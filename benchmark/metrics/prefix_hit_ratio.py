"""Prompt tokens served from the radix prefix cache over the prompt tokens of
the requests admitted while the window was open (``RequestResult.prefix_tokens``)."""


def read(run):
    w = run.window
    admitted = [o for o in w.outcomes if o.admit_s is not None and o.admit_s >= w.t_open]
    total = sum(o.prompt_len for o in admitted)
    return 100.0 * sum(o.prefix_tokens for o in admitted) / total if total else None
