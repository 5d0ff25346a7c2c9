"""A seeded host pool of ``pool`` encoded training batches
(``synth.train_batches``), cycled in order; no data layer."""

from mfbench import synth
from mfbench.sources import Feed


def make(traffic, shape, seed, prog, cfg, scratch) -> Feed:
    pool = synth.train_batches(seed, traffic["pool"], batch=shape["batch"],
                               height=shape["height"], width=shape["width"],
                               objects=traffic["objects"])
    return Feed(next=lambda i: pool[i % len(pool)], steps_per_epoch=len(pool), pool=pool)
