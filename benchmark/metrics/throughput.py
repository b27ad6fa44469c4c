"""Images answered over the whole measured window, per second of it."""


def read(run):
    return run.window.images / run.window.seconds
