"""A seeded host pool of ``pool`` batches of what forward + decode reads
(``synth.inference_batches``: uint8 images, edge chain, camera), cycled in
order."""

from mfbench import synth
from mfbench.sources import Feed


def make(traffic, shape, seed, prog, cfg, scratch) -> Feed:
    pool = synth.inference_batches(seed, traffic["pool"], batch=shape["batch"],
                                   height=shape["height"], width=shape["width"],
                                   objects=traffic["objects"])
    return Feed(next=lambda i: pool[i % len(pool)], steps_per_epoch=len(pool), pool=pool)
