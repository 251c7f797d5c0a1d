"""chip_smoke.py and what it rests on, checked on the CPU at tiny size:
the numpy chain-MPO builder, the phase functions and their references,
the refusal to run without a GPU, the compile-cache rule, and imports
without networkx/h5py. The full run is the ``gpu``-marked test."""

import json
import os
import shutil
import subprocess
import sys

import jax
import networkx as nx
import numpy as np
import pytest

import chip_smoke
from tensor4all_tpu.models.chain import (
    heisenberg_chain_mpo,
    mpo_to_dense,
    tfi_chain_mpo,
)
from tensor4all_tpu.models.spin import heisenberg, transverse_field_ising
from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
from tensor4all_tpu.treetn.network import random_treetn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


@pytest.mark.parametrize("N", [4, 6])
@pytest.mark.parametrize("model", ["heisenberg", "tfi"])
def test_chain_mpo_matches_tree_compiler(model, N):
    g = nx.path_graph(N)
    _, si = random_treetn(jax.random.PRNGKey(0), g,
                          {n: [2] for n in g.nodes}, bond_dim=2)
    sites = {n: si[n][0] for n in g.nodes}
    if model == "heisenberg":
        op, cores = heisenberg(g, sites), heisenberg_chain_mpo(N)
    else:
        op = transverse_field_ising(g, sites, h=0.7)
        cores = tfi_chain_mpo(N, h=0.7)
    want = mpo_to_dense(treeoperator_to_mpo_cores(op, list(range(N))))
    np.testing.assert_allclose(mpo_to_dense(cores), want, atol=1e-14)


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_exact_tiny():
    r = chip_smoke.phase_exact(N=6, chi=8, n_sweeps=3)
    assert r["abs_err"] <= chip_smoke.EXACT_ABS_TOL


def test_phase_dmrg_tiny():
    r = chip_smoke.phase_dmrg(N=6, chi=8)
    assert r["rel_gap"] <= chip_smoke.DMRG_REL_TOL
    assert r["knobs"]["coarse_bf16"] and r["n_sweeps"] == 3


def test_phase_tdvp_tiny():
    r = chip_smoke.phase_tdvp(N=6, chi=8)
    assert 0.0 <= r["infidelity"] <= chip_smoke.TDVP_INFIDELITY_TOL
    assert r["knobs"]["bf16_tail"] == 2


def test_phase_tci():
    r = chip_smoke.phase_tci()
    assert r["sampled_rel_err"] <= r["tol"] and r["rank"] >= 1


def test_phase_sharded_tiny():
    r = chip_smoke.phase_sharded(4, N=8, chi_dmrg=8, chi_tdvp=8)
    assert r["dmrg_output_devices"] == r["tdvp_output_devices"] == 4
    assert r["rel_gap"] <= chip_smoke.DMRG_REL_TOL


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_rule(preset, tmp_path):
    code = ("import jax\n"
            "from tensor4all_tpu.utils.compile_cache import "
            "use_compile_cache, CHECKOUT_CACHE_DIR\n"
            "print(repr(use_compile_cache()))\n"
            "print(repr(jax.config.jax_compilation_cache_dir))\n"
            "print(repr(CHECKOUT_CACHE_DIR))\n")
    env = _child_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    used, configured, checkout = (eval(x) for x in r.stdout.split("\n")[:3])
    assert checkout == os.path.join(REPO, ".jax_cache")
    if preset:
        assert used == configured == str(tmp_path)
    else:
        assert used == configured == checkout


def test_imports_without_networkx_and_h5py():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('networkx', 'h5py'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import chip_smoke\n"
        "from benchmarks.dmrg_chain import _setup, headline, prod_row\n"
        "h, mps = _setup(6, 8)\n"
        "print(h.shape, mps.shape)\n"
        "print(chip_smoke.phase_exact(N=4, chi=4, n_sweeps=2)['abs_err'])\n"
        "assert 'networkx' not in sys.modules and 'h5py' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "(6, 5, 2, 2, 5) (6, 8, 2, 8)" in r.stdout


def test_device_peaks_refuses_unknown_card():
    from benchmarks.mxu import device_peaks

    assert device_peaks("NVIDIA H100 80GB HBM3")["bf16_tflops"] == 989.0
    with pytest.raises(KeyError):
        device_peaks("cpu")


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The full smoke on the card, in a child process that owns it."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"],
                                     capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in _child_env().items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
