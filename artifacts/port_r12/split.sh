# The split of measure.sh's zoo slowdown, on one H100 from the root of a
# checkout with the parent under _ab/parent: two rounds, alternating the
# order, of deeplabv2_r50 and unet2d through `python -m
# ust_run_tpu_torch.bench` on the parent, on this tree at --deterministic
# 1, and on this tree with cuDNN as the parent left it
# (bench_cudnn_free.py). Raw output in OUT_DIR/split.txt:
#   bash artifacts/port_r12/split.sh OUT_DIR
out=${1:?usage: split.sh OUT_DIR}; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # LABEL DIR COMMAND...
  label=$1; dir=$2; shift 2
  for m in deeplabv2_r50 unet2d; do
    echo "$label $m"
    (cd $dir && UST_BENCH_MODEL=$m UST_BENCH_WATCHDOG=600 "$@" 2>&1 | grep -v -i warn)
  done
}
for r in 1 2; do
  echo "round $r"
  if [ $r = 1 ]; then
    run parent _ab/parent python -m ust_run_tpu_torch.bench
    run change . python -m ust_run_tpu_torch.bench
    run cudnn_free . python artifacts/port_r12/bench_cudnn_free.py
  else
    run cudnn_free . python artifacts/port_r12/bench_cudnn_free.py
    run change . python -m ust_run_tpu_torch.bench
    run parent _ab/parent python -m ust_run_tpu_torch.bench
  fi
done > $out/split.txt 2>&1
grep -A1 "^parent\|^change\|^cudnn_free" $out/split.txt | grep "^parent\|^change\|^cudnn_free\|\"value\""
