"""Images of the training steps done in the window over the window's
seconds (the window ends in a synchronise)."""


def read(run):
    return run.images_per_s() if run.kind == "train" and run.window_s > 0 else None
