"""Images whose decoded rows reached the host in the window over the
window's seconds (closed loop)."""


def read(run):
    if run.kind != "infer" or run.latencies_s or run.window_s <= 0:
        return None
    return run.images_per_s()
