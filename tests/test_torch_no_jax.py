"""The PyTorch port imports neither jax nor the JAX package: the GPU
machine it runs on has no jax installed."""

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
        "          'slam_map.keyframe_db', 'slam_map.atlas'):\n"
        "    assert 'openmavis_tpu_torch.' + n in names, n\n"
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
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'openmavis_tpu' or m.startswith('openmavis_tpu.'))\n"
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
