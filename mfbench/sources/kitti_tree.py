"""The data layer over a KITTI training tree: ``frames`` frames of
``frame_size`` rendered from the seed (``synth.write_kitti_tree``) into the
run's scratch directory, read by the program's dataset (with the flip the
configuration states) and its threaded loader; the frames cycle over
epochs.  The check holds each batch the loader made to the reference's own
encoding of the same frames (``data_gap``)."""

import os

from mfbench import synth
from mfbench.sources import Feed


def make(traffic, shape, seed, prog, cfg, scratch) -> Feed:
    root = os.path.join(scratch, "kitti", "training")
    synth.write_kitti_tree(root, seed, traffic["frames"], traffic["frame_size"][0],
                           traffic["frame_size"][1], traffic["objects"],
                           traffic["class_shares"])
    dataset, loader = prog.train_loader(cfg, root, seed)
    it = iter(loader)

    def judge_batches(record, tree):
        from mfbench import check
        from mfbench.reference import model as ref

        samples = ref.KittiSamples(tree, root)
        judged = [check.data_gap(b, [samples.candidates(i) for i in b["image_id"]])
                  for b in record["batches"]]
        return [b for _, b in judged], {"data_gap": max(gap for gap, _ in judged)}

    return Feed(next=lambda i: next(it), steps_per_epoch=max(1, len(dataset) // shape["batch"]),
                close=it.close, judge_batches=judge_batches)
