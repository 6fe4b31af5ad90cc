# Before and after on one H100, from the root of a checkout with the
# parent commit unpacked under _ab/parent (git archive <parent> | tar -x
# -C _ab/parent): artifacts/port_r12/detect.py on each tree, then four
# rounds of `python -m ust_run_tpu_torch.bench` (the trainer's K-step
# call, UST_BENCH_UNROLL at its default 10) for the fundus UNet,
# deeplabv2_r50 and unet2d on each tree, the change's fundus also at
# --deterministic 0; rounds 1 and 4 run the parent first, 2 and 3 the
# change. Raw output under the directory given as the first argument:
#   bash artifacts/port_r12/measure.sh OUT_DIR
out=${1:?usage: measure.sh OUT_DIR}; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $out/card.txt
for t in _ab/parent .; do
  echo "tree $t"; python artifacts/port_r12/detect.py $t 2>&1 | grep "^\[detect\]\|Error"
done > $out/detect.txt 2>&1
bench() {  # TREE LABEL [env and flags...]
  tree=$1; label=$2; shift 2
  echo "$label"
  (cd $tree && env "$@" UST_BENCH_WATCHDOG=600 python -m ust_run_tpu_torch.bench $BENCH_FLAGS 2>&1 | grep -v -i warn)
}
parent() {
  for m in unet deeplabv2_r50 unet2d; do
    BENCH_FLAGS= bench _ab/parent "parent $m" UST_BENCH_MODEL=$m
  done
}
change() {
  for m in unet deeplabv2_r50 unet2d; do
    BENCH_FLAGS= bench . "change $m deterministic 1" UST_BENCH_MODEL=$m
  done
  BENCH_FLAGS="--deterministic 0" bench . "change unet deterministic 0" UST_BENCH_MODEL=unet
}
for r in 1 2 3 4; do
  echo "round $r"
  if [ $r = 1 ] || [ $r = 4 ]; then parent; change; else change; parent; fi
done > $out/bench.txt 2>&1
cat $out/detect.txt
grep -A2 "^parent\|^change" $out/bench.txt | grep "^parent\|^change\|\"value\"" | head -80
