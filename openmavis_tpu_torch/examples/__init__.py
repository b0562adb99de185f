"""The example mains (port of `examples/` and `scripts/train_vocab.py`).

One module per reference main, named the same, each with
`main(argv=None)`; run one as

    python -m openmavis_tpu_torch.examples.<name> <sequence> [flags]

The flags, defaults and built-in calibrations are the reference mains',
and so are the lines they print to stderr (`replayed ... fps`,
`imu_init...`, `ATE RMSE ...`). Each main adds `--device`: the run is on
the current CUDA device unless it names another (`--device cpu`), and
without a GPU it raises `RuntimeError` rather than carry on on the CPU.

System mains: mono_euroc (also `--streaming`, the one-camera streaming
tracker), mono_kitti, mono_tum, mono_inertial_euroc, mono_inertial_tum_vi,
stereo_euroc, stereo_kitti, stereo_inertial_euroc, stereo_inertial_tum_vi,
rgbd_tum, rgbd_inertial, multisession_euroc. The flagship,
multi_inertial_euroc, drives the streaming VI tracker with a host loop
closer. train_vocab trains and saves an ORB vocabulary.
"""
