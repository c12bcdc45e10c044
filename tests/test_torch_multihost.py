"""Two processes over localhost, the counterpart of ``tests/test_multihost.py``
for the port: each joins the process group through
``parallel/mesh.py:initialize_multihost`` (Gloo on the CPU), loads only its
half of the batch, and computes its share of the eval-mode weighted-CCE
loss of the tiny AASIST (normalised by the global weight sum) and its
gradients, summed over the two (``Ranks.sum_grads``).  The loss and every
gradient equal the JAX package's single-device ones on the whole batch,
at ``tests/multihost_worker.py``'s 1e-5.  Then the dry run,
``python -m aasist_tpu_torch.tools.dryrun_multigpu --nproc 2 --device
cpu``, passes its seven phases.

The worker is this file run as a script; every process has a 30 s
process-group timeout and a bound on its run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from aasist_tpu_torch.parallel import launch, mesh  # noqa: E402

TINY_CONF = {
    "architecture": "AASIST",
    "first_conv": 128,
    "filts": [70, [1, 8], [8, 8], [8, 12], [12, 12]],
    "gat_dims": [12, 16],
    "pool_ratios": [0.5, 0.7, 0.5, 0.5],
    "temperatures": [2.0, 2.0, 100.0, 100.0],
}
TIMEOUT = 240


def _batch():
    x = (np.random.default_rng(5).standard_normal((8, 16000))
         .astype(np.float32) * 0.05)
    return x, (np.arange(8) % 2).astype(np.int64)


def _worker(process_id: int, port: int, out: str) -> None:
    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.train.losses import weighted_cce
    from aasist_tpu_torch.weights import load_npz

    torch.set_num_threads(1)
    ranks = mesh.initialize_multihost(f"localhost:{port}", 2, process_id,
                                      device="cpu", timeout_s=30)
    try:
        model = load_npz(build_model(TINY_CONF), Path(out) / "weights.npz")
        x, y = _batch()
        lo, hi = process_id * 4, process_id * 4 + 4      # this host's half
        logits = model(torch.from_numpy(x[lo:hi]))[1]
        loss = weighted_cce(logits, torch.from_numpy(y[lo:hi]), ranks=ranks)
        loss.backward()
        ranks.sum_grads(list(model.parameters()))
        total = ranks.sum_(loss.detach().clone())
        np.savez(Path(out) / f"rank{process_id}.npz", loss=total.numpy(),
                 **{k: p.grad.numpy() for k, p in model.named_parameters()
                    if p.grad is not None})
    finally:
        mesh.shutdown(ranks)
    print(f"MULTIHOST_OK process={process_id} loss={float(total):.6f}",
          flush=True)


def test_two_process_data_parallel(tmp_path):
    import jax

    from aasist_tpu.registry import build_model as jax_build_model
    from aasist_tpu.train.losses import weighted_cce as jax_weighted_cce

    from aasist_tpu_torch.registry import build_model
    from aasist_tpu_torch.weights import load_jax_params, save_npz

    from test_torch_train_models import _flat

    jm = jax_build_model(TINY_CONF)
    params, state = jm.init(jax.random.PRNGKey(0))
    save_npz(load_jax_params(build_model(TINY_CONF), params, state),
             tmp_path / "weights.npz")
    x, y = _batch()

    def loss_fn(p, xx, yy):
        (_, logits), _ = jm.apply(p, state, xx, train=False)
        return jax_weighted_cce(logits, yy)

    ref_loss, g_ref = jax.jit(jax.value_and_grad(loss_fn))(params, x, y)
    g_ref = _flat(g_ref)

    port = launch.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(i), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-3000:]
    for i in range(2):
        got = dict(np.load(tmp_path / f"rank{i}.npz"))
        assert abs(float(got.pop("loss")) - float(ref_loss)) < 1e-5
        assert set(got) <= set(g_ref)
        for k, want in g_ref.items():
            np.testing.assert_allclose(got.get(k, np.zeros_like(want)),
                                       want, atol=1e-5, rtol=1e-4,
                                       err_msg=k)


def test_dry_run_passes_on_two_cpu_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "aasist_tpu_torch.tools.dryrun_multigpu",
         "--nproc", "2", "--device", "cpu", "--timeout", str(TIMEOUT)],
        capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=TIMEOUT + 30)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("dryrun_multigpu(2)")]
    assert "backend gloo" in lines[0]
    assert lines[-1].endswith("all phases passed"), res.stdout[-3000:]
    assert len(lines) == 9, res.stdout


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
