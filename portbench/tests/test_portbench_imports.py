"""What a run loads and how it ends without a card."""

import json
import os
import subprocess
import sys

from pb import imports

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")


def test_top_level_names_are_compared_whole():
    assert imports.forbidden_loaded(["graspldm_tpu_torch.models.pvcnn", "numpy"]) == []
    assert imports.forbidden_loaded(["graspldm_tpu.config"]) == ["graspldm_tpu"]
    assert imports.forbidden_loaded(["jaxlib.xla_client", "flax"]) == ["flax", "jaxlib"]
    assert imports.forbidden_loaded(["jaxtyping", "flaxen"]) == []
    assert imports.forbidden_loaded(["graspldm_tpu_torch"],
                                    imports.FORBIDDEN_IN_REFERENCE) == ["graspldm_tpu_torch"]


def _loaded_after(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([BENCH, ROOT]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """A whole small run on the CPU, in a fresh process."""
    code = ("import sys; sys.path.insert(0, 'portbench/tests')\n"
            "from shrink import small_cell\nfrom pb.harness import run_cell\n"
            "out = run_cell('fpc.batch', 3, 0.5, False, device='cpu',\n"
            "               cell=small_cell('fpc.batch'))\n"
            "assert out.result['correct'], out\n")
    mods = _loaded_after(code)
    assert "graspldm_tpu_torch" in mods
    assert imports.forbidden_loaded(mods) == []


def test_the_reference_loads_neither_jax_nor_the_program():
    code = ("import torch\nfrom reference import model, generate\n"
            "cfg = __import__('json').load(open('portbench/configs/graspldm-fpc-z4-pc64.json'))\n"
            "vae, ddm = model.build(cfg, 'cpu')\n")
    assert imports.forbidden_loaded(_loaded_after(code), imports.FORBIDDEN_IN_REFERENCE) == []


def test_without_a_card_a_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fpc.batch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
