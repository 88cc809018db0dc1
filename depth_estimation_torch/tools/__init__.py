"""Command-line studies and benchmarks of the port, each the counterpart
of one script of the JAX system's `tools/` directory, run as

    python -m depth_estimation_torch.tools.<name> [--device cpu] ...

on the GPU unless `--device cpu` is given. Each prints one JSON line (the
suite one a configuration) and writes a file only where `--out` is given.

- `profile_stages` ports `tools/profile_stages.py`: per-stage timing of
  the lattice pipeline (update, elemwise, embed, plan, splat, blur, slice,
  apply, cost volume, whole pipeline); `--fused-update 1` takes the fused
  mean-field kernel in the pipeline stage and reports its launches a call.
- `tiled_stereo_study` ports `tools/tiled_stereo_study.py`: the halo sweep
  of the row-tiled stereo on the Tsukuba pair (`--mode halo`) and the
  overhead of the tiled wrapper on one rank (`--mode time`).
- `train_detect_scaled` ports `tools/train_detect_scaled.py`: a Mask-RCNN
  at ResNet-18 depth whose body is imported from a synthetic
  torchvision-layout checkpoint and grafted, trained heads first, then all
  layers, with held-out mAP.
- `train_coco_scaled` ports `tools/train_coco_scaled.py`: procedural
  shapes exported as a COCO json + png tree, trained through
  `COCODetection` and `train_detection_coco`.
- `bench_suite` ports `tools/bench_suite.py`: one measurement of each of
  the JAX suite's five configurations (tsukuba_dense, middlebury64,
  trainable_step, fullres128, serving_batched), a JSON line each with the
  JAX suite's keys and the fused-update kernels' launches per call.
- `bench_scaling` ports `tools/bench_scaling.py`: frames/s of the batched
  lattice pipeline over world sizes of a `torch.distributed` world, capped
  at the cards present.

`bench.py`'s counterpart is `bench_torch.py` at the repo's root. The JAX
system's `BENCH_SUITE.json` and `SCALING.json` hold a TPU's numbers; the
port neither reads nor writes them.
"""
