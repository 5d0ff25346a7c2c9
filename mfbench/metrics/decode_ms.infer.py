"""Device ms of the decode (``decode/postprocessor.py``) per batch: CUDA
events around each ``PostProcessor`` call of the traced part, their mean."""


def read(run):
    return sum(run.decode_ms) / len(run.decode_ms) if run.decode_ms else None
