#!/bin/bash
# Interleaved untraced runs, parent P (a `git archive` of the parent under
# the ignored _ab/parent) and change C (.), one seed per pair: P C C P per
# cell; then each tree's host cost a layer call and GroupedBatchNorm's
# eager share. Run from the repo root on a card: bash artifacts/port_r16/ab.sh SEED1 SEED2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
out=$PWD/chiprun_out/pr16
mkdir -p $out
run() {  # tree tag cell seed
  (cd $1 && python3 -m benchmarks.run --workload $3 --seed $4 --seconds 30 --trace 0 > $out/ab_$2_$3_$4.out 2> $out/ab_$2_$3_$4.err)
  echo "$2 $3 $4 rc=$? $(tail -n 1 $out/ab_$2_$3_$4.out | python3 -c "import json,sys; d=json.loads(sys.stdin.read()); print(d.get('correct'), json.dumps(d.get('metrics')))" 2>&1)"
}
for cell in unet_fundus.graph deeplabv2_r101_fundus.graph unet_fundus.eager; do
  run _ab/parent P $cell $1
  run . C $cell $1
  run . C $cell $2
  run _ab/parent P $cell $2
done
for spec in "_ab/parent unfused" ". fused" ". fused" "_ab/parent unfused"; do
  python3 artifacts/port_r16/host_us.py $spec 2>>$out/host_us.err | tail -n 1
done
for model in unet deeplabv2; do
  for tree in _ab/parent .; do
    python3 artifacts/port_r16/bn_share.py $tree $model 3 2>$out/share_$(basename $tree)_$model.err | tail -n 1
  done
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
