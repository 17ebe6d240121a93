"""Output tokens the engine emitted while the window was open (by requests
that retired and by those the drain caught), over the window's wall seconds."""


def read(run):
    return run.window.served() / run.window.seconds
