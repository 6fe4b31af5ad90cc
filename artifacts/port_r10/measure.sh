# Five interleaved rounds of `python -m ust_run_tpu_torch.bench` at
# UST_BENCH_UNROLL 1 and 10 (the order alternating by round) for the
# fundus UNet and deeplabv2_r50, then `python3 chip_smoke.py --profile`;
# run from the root of a checkout on one H100 (raw output under
# chiprun_out/, copied here).
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for r in 1 2 3 4 5; do
  for m in unet deeplabv2_r50; do
    if [ $((r % 2)) = 1 ]; then us="1 10"; else us="10 1"; fi
    for u in $us; do
      echo "run $r model $m unroll $u"
      UST_BENCH_MODEL=$m UST_BENCH_UNROLL=$u python -m ust_run_tpu_torch.bench 2>&1 | grep -v -i warn
    done
  done
done > chiprun_out/bench.txt 2>&1
python3 chip_smoke.py --profile chiprun_out/profile.json > chiprun_out/smoke_call1.txt 2>&1
echo smoke rc $?
grep "^\[time\]\|FAIL\|Error" chiprun_out/smoke_call1.txt | tail -30
tail -3 chiprun_out/smoke_call1.txt
