"""The port's command line after a restore: the DCN offset guard
(``utils/dcn_guard.py``) under "warn" and "auto", on a model whose ida_0
offsets pass the clamp and on one without DCNs.  CPU drives under
``MONOFLEX_PLATFORM=cpu`` on the 1/4-scale synthetic KITTI tree at 96x320,
with ``tests/test_torch_cli.py``'s options (split from that file, whose
wall time set the test run's).
"""

import torch

from test_torch_cli import OPTS, data_dir, out, run_cli, scalars  # noqa: F401 (fixtures)


def saturate_offsets(ckpt_path, stage="backbone.dla_up.ida_0."):
    """Set the offset biases of one neck stage's DCNs to 7 pixels in a saved
    checkpoint, as unbounded-trained weights would have them."""
    ckpt = torch.load(ckpt_path, weights_only=True)
    for name, value in ckpt["model"].items():
        if name.startswith(stage) and name.endswith("conv_offset_mask.bias"):
            value[:18] = 7.0
    torch.save(ckpt, ckpt_path)


def test_offset_guard_after_a_restore(data_dir, out):  # noqa: F811
    """A restored checkpoint whose ida_0 offsets pass the clamp: "warn" logs
    the table and runs on the clamped kernel path; "auto" reroutes ida_0 onto
    the unbounded gather and the resumed run goes on from there."""
    env = {"MONOFLEX_DATA_DIR": str(data_dir)}
    flags = ("--config", "runs/monoflex.yaml", "--output", str(out))
    args = (*flags, *OPTS, "SOLVER.IMS_PER_BATCH", "2", "SOLVER.EVAL_INTERVAL", "100")
    r = run_cli(*args, "SOLVER.MAX_ITERATION", "1", **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "DCN OFFSET GUARD" not in r.stdout + r.stderr      # nothing restored
    saturate_offsets(out / "ckpt" / "model_final")

    r = run_cli(*flags, "--eval", "--ckpt", str(out / "ckpt" / "model_final"), *OPTS, **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    log = r.stdout + r.stderr
    assert "DCN OFFSET GUARD" in log and "stage 0 impl=pallas3b" in log
    assert "SATURATES" in log and "rebuilding model" not in log
    assert "Car AP@0.70" in r.stdout

    r = run_cli(*args, "SOLVER.MAX_ITERATION", "2", "TPU.DCN_OFFSET_GUARD", "auto", **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    log = r.stdout + r.stderr
    assert "resumed from iteration 1" in log
    assert ("rebuilding model with TPU.DCN_IMPL_PER_STAGE=['gather', 'pallas3b', 'pallas3b', "
            "'pallas3b']") in log
    assert "iter 2/2" in r.stdout
    assert scalars(out)[-1]["step"] == 2


def test_offset_guard_restores_a_model_without_dcns(data_dir, out):  # noqa: F811
    """dlav0's neck has no DCNs: after a restore the guard, under "warn"
    (the default) and under "auto", finds no offsets, fires nothing and
    the resumed run goes on."""
    env = {"MONOFLEX_DATA_DIR": str(data_dir)}
    args = ("--config", "runs/monoflex.yaml", "--output", str(out), *OPTS,
            "MODEL.BACKBONE.CONV_BODY", "dlav0", "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.EVAL_INTERVAL", "100")
    r = run_cli(*args, "SOLVER.MAX_ITERATION", "1", **env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    for it, mode in ((2, "warn"), (3, "auto")):
        r = run_cli(*args, "SOLVER.MAX_ITERATION", str(it), "TPU.DCN_OFFSET_GUARD", mode, **env)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        log = r.stdout + r.stderr
        assert f"resumed from iteration {it - 1}" in log
        assert "DCN OFFSET GUARD" not in log and "rebuilding model" not in log
        assert f"iter {it}/{it}" in r.stdout
    assert scalars(out)[-1]["step"] == 3
