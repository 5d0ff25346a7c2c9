"""The benchmark's plain BEVFormer: ``bevformer.py`` is a frozen copy of
``tests/plain_bevformer.py`` (the plain-PyTorch model with the published
``nonzero`` rebatch, its seeded weights and the published decode), whose
trunk and FPN are ``reference_fcos3d/``'s, importing nothing of the port,
so that no change to the program can change what it is judged against;
``model.py`` is the benchmark's entry to it.
"""
