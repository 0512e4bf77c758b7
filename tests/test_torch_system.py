"""End-to-end system behaviour on the port, the mesh-free cases of
``tests/test_system.py``: train -> checkpoint -> restore -> serve, and
the paper-reproduction pipeline in miniature, on the CPU."""
import numpy as np
import torch

from _torch_threads import one_cpu_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig, get_arch
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.models import build
from repro_torch.optim import init_opt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import TrainLoop, make_train_step


def test_train_checkpoint_serve_pipeline(tmp_path):
    """The quickstart path: a model is trained, checkpointed, restored
    into fresh weights (a "new process"), and served."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tc = TrainConfig(total_steps=6, warmup_steps=1, checkpoint_every=3,
                     learning_rate=5e-3)
    step_fn = make_train_step(model, tc)
    dc = DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=1)

    def batch_fn(s):
        return {"tokens": SyntheticStream(dc, start_step=s).batch_at(s)}

    ckpt = CheckpointManager(str(tmp_path), keep=2)
    res = TrainLoop(step_fn, batch_fn, tc, ckpt=ckpt).run(params, num_steps=6)
    assert res.metrics_history[-1]["loss"] < res.metrics_history[0]["loss"]

    fresh = build(cfg).init(torch.Generator().manual_seed(42), device="cpu")
    (restored, _), step = ckpt.restore((fresh, init_opt(fresh)))
    assert step == 6
    trained = dict(res.params.named_parameters())
    assert all(torch.equal(w, trained[n]) for n, w in restored.named_parameters())
    eng = ServeEngine(model, restored, batch_slots=2, max_len=24, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=3))
    eng.run_until_drained()
    assert len(eng.completed[0].out) == 3


def test_paper_pipeline_miniature():
    """Paper repro in miniature: matrix -> two-level partition -> BELL ->
    distributed PMVC == CSR, with LB and comm stats recorded."""
    from repro_torch.core.combined import two_level_partition
    from repro_torch.pmvc.dist import pmvc_simulate
    from repro_torch.pmvc.plan_device import pack_units
    from repro_torch.sparse.formats import csr_from_coo
    from repro_torch.sparse.generate import banded_coo

    a = banded_coo(512, 6000, seed=0)
    results = {}
    for combo in ("NL-HL", "NC-HC"):
        plan = two_level_partition(a, 4, 4, combo)
        unit = plan.elem_node.astype(np.int64) * 4 + plan.elem_core
        dp = pack_units(a, unit, 16, 16, 16)
        y = pmvc_simulate(dp, np.ones(512, np.float32), device="cpu")
        y_ref = csr_from_coo(a).matvec(np.ones(512, np.float32))
        np.testing.assert_allclose(y, y_ref, rtol=2e-4, atol=2e-4)
        results[combo] = (plan.lb_cores, plan.scatter_volume)
    # Both combos balanced within the paper's observed band.
    assert all(lb < 3.0 for lb, _ in results.values())
