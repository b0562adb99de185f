"""The PyTorch port imports neither jax nor the JAX package: the GPU
machine it runs on has no jax installed. Nor does any of its modules import
PyYAML or Pillow when it is imported: that machine may lack them too. The
example mains are modules of the port (`openmavis_tpu_torch.examples`)
and are held to the same, and so are the four modules of `parallel/`."""

import pathlib
import subprocess
import sys


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import openmavis_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    openmavis_tpu_torch.__path__, 'openmavis_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('pipeline.streaming_lc', 'pipeline.loop_closing',\n"
        "          'solvers.sim3', 'solvers.pnp', 'optim.pose_graph',\n"
        "          'optim.sim3_refine', 'solvers.two_view',\n"
        "          'frontend.depth', 'slam_map.vocabulary',\n"
        "          'slam_map.keyframe_db', 'slam_map.atlas',\n"
        "          'utils.timing', 'io.trajectory', 'io.serialization',\n"
        "          'io.settings', 'io.datasets', 'io.native_loader',\n"
        "          'frontend.rectify', 'pipeline.viewer',\n"
        "          'pipeline.system', 'examples.scenes'):\n"
        "    assert 'openmavis_tpu_torch.' + n in names, n\n"
        "mains = ('mono_euroc', 'mono_kitti', 'mono_tum',\n"
        "         'mono_inertial_euroc', 'mono_inertial_tum_vi',\n"
        "         'stereo_euroc', 'stereo_kitti', 'stereo_inertial_euroc',\n"
        "         'stereo_inertial_tum_vi', 'rgbd_tum', 'rgbd_inertial',\n"
        "         'multi_inertial_euroc', 'multisession_euroc',\n"
        "         'train_vocab')\n"
        "for n in mains:\n"
        "    m = importlib.import_module(\n"
        "        'openmavis_tpu_torch.examples.' + n)\n"
        "    assert callable(m.main), n\n"
        "from openmavis_tpu_torch.frontend import orb\n"
        "for n in ('moment_kernels', 'orientation_maps', 'keypoint_angles',\n"
        "          'describe', 'keypoint_angles_stacked',\n"
        "          'describe_stacked'):\n"
        "    assert hasattr(orb, n), n\n"
        "from openmavis_tpu_torch.pipeline import multi_tracking\n"
        "for n in ('MultiTracker', 'MultiTrackerConfig'):\n"
        "    assert hasattr(multi_tracking, n), n\n"
        "from openmavis_tpu_torch.pipeline import streaming, tracking\n"
        "for mod, n in ((tracking, 'Tracker'), (tracking, 'TrackerConfig'),\n"
        "               (streaming, 'StreamingTracker'),\n"
        "               (streaming, 'StreamConfig')):\n"
        "    assert hasattr(mod, n), n\n"
        "from openmavis_tpu_torch.slam_map import atlas\n"
        "for n in ('Atlas', 'transform_map', 'merge_maps',\n"
        "          'merge_maps_device'):\n"
        "    assert hasattr(atlas, n), n\n"
        "from openmavis_tpu_torch.pipeline import loop_closing\n"
        "for n in ('LoopCloser', 'LoopConfig'):\n"
        "    assert hasattr(loop_closing, n), n\n"
        "from openmavis_tpu_torch.pipeline import system\n"
        "assert len(system.Sensor) == 8 and hasattr(system, 'System')\n"
        "for n in ('parallel', 'parallel.dist_ba', 'parallel.dist_place',\n"
        "          'parallel.multihost'):\n"
        "    assert 'openmavis_tpu_torch.' + n in sys.modules, n\n"
        "from openmavis_tpu_torch.parallel import dist_ba, dist_place\n"
        "from openmavis_tpu_torch.parallel import multihost\n"
        "for mod, n in ((dist_ba, 'make_mesh'), (dist_ba, 'resolve_mesh'),\n"
        "               (dist_ba, 'shard_observations_by_landmark'),\n"
        "               (dist_ba, 'distributed_bundle_adjust'),\n"
        "               (dist_ba, 'distributed_global_ba'),\n"
        "               (dist_ba, 'distributed_global_ba_lsharded'),\n"
        "               (dist_place, 'sharded_place_scores'),\n"
        "               (multihost, 'initialize'),\n"
        "               (multihost, 'global_mesh'),\n"
        "               (multihost, 'host_local_to_global'),\n"
        "               (multihost, 'process_count'),\n"
        "               (multihost, 'process_index')):\n"
        "    assert hasattr(mod, n), n\n"
        "from openmavis_tpu_torch.pipeline import tracking\n"
        "assert hasattr(tracking, 'distributed_global_ba_step')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'openmavis_tpu' or m.startswith('openmavis_tpu.')\n"
        "             or m.split('.')[0] in ('yaml', 'PIL'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
