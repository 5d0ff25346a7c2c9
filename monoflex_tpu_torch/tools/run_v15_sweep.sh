#!/bin/bash
# The v15-layout forward (a route onto csrc/dcn_fwd.cu) checked and timed on
# the card at the JAX script's 8 DCN shapes, then its bf16 window math at the
# hot shape: the port's counterpart of tools/run_v15_sweep.sh.  Every run of
# fwd_ablate appends to one log (default output/v15_sweep.log); a shape that
# fails is logged and the sweep goes on.  Exits 1 without a card, or when a
# run failed.
#
#   bash monoflex_tpu_torch/tools/run_v15_sweep.sh [LOG]
case "$1" in
  -h|--help) sed -n '2,9p' "$0" | sed 's/^# \{0,1\}//'; exit 0 ;;
esac
cd "$(dirname "$0")/../.." || exit 1
OUT=${1:-output/v15_sweep.log}
python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)' || {
  echo "run_v15_sweep.sh: no CUDA device; the port's kernels run only on the GPU" >&2; exit 1; }
mkdir -p "$(dirname "$OUT")"
: > "$OUT"
rc=0
for s in 96,320,64,64 48,160,64,64 48,160,128,128 48,160,128,64 \
         24,80,256,128 24,80,256,256 24,80,64,64 12,40,512,256; do
  echo "=== shape $s ===" >> "$OUT"
  python -m monoflex_tpu_torch.tools.fwd_ablate --variants v15 --parity --shape "$s" \
      --iters 10 >> "$OUT" 2>&1 || rc=1
done
echo "=== bf16 at hot shape ===" >> "$OUT"
python -m monoflex_tpu_torch.tools.fwd_ablate --variants v15bf16 --shape 96,320,64,64 \
    --iters 10 >> "$OUT" 2>&1 || rc=1
echo "SWEEP DONE" >> "$OUT"
exit $rc
