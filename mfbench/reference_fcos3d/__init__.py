"""The benchmark's plain FCOS3D: ``fcos3d.py`` is a frozen copy of
``tests/plain_fcos3d.py`` (the plain-PyTorch model, its seeded weights and
the published decode with a sequential greedy rotated NMS), importing
nothing of the port, so that no change to the program can change what it
is judged against; ``model.py`` is the benchmark's entry to it.
"""
