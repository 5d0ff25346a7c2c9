"""The benchmark's plain reference: a frozen copy of the port's plain
modules (model with the DCN as a PyTorch gather, the 11-term loss, AdamW,
decode, the KITTI sample encoding), importing nothing of the port, so that
no change to the program can change what it is judged against.  The copies
keep their module docstrings; ``model.py`` is the benchmark's entry to them.
"""
