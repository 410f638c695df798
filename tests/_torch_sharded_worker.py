"""One rank of a multi-rank run of the port, for
``tests/test_torch_sharded.py`` and ``tests/test_torch_gpu.py`` (imports
torch and the port only), and :func:`run_ranks`, which starts them.

    python tests/_torch_sharded_worker.py MODE INIT_URL WORLD RANK DIR

``step``: for every case in ``DIR/cases.json`` (inputs in
``DIR/case<i>.npz``: the full initial table and optimizer tables, the
global batches), run ``sparse_step_shardmap`` on this rank's model shard
and data block and write ``DIR/out<i>_<rank>.npz`` (its scores, shards
and w0); a case of the dense optax path (``sparse_update`` false, or
an optimizer or L2 the sparse step does not take) runs
``dense_step_sharded`` from a fresh optimizer state on the shard
instead, and also writes what each step applied (``dw0``, the shard's
``dtable``) and the parameters it started from (``w0_before``,
``table_before``).  ``step_cuda``: the same on ``cuda:0`` (ranks
sharing the card over gloo).  ``trainer``: for every case in
``DIR/trainer.json``, a ``Trainer`` of the case's config (warm-started
from its ``model_file``) takes the case's global batches ``first`` to
``first + steps`` of ``DIR/<batches>.npz`` through ``train_step`` (its
data block of each), saves, and writes ``DIR/trainer<i>_<rank>.json``
(the global metrics).  ``train``: run ``Trainer.train()`` for each config in
``DIR/train.json`` and write its result to ``DIR/train<i>_<rank>.json``
(a config's ``_exact_bytes_max`` key, when present, sets
``train.tiered.EXACT_BYTES_MAX`` for its run: 0 makes the cold stores
virtual; its ``_evaluate`` key, a list of files, is evaluated after the
run, and a RuntimeError's message kept as ``evaluate_error``; its
``_status_ports`` key gives each rank its ``status_port``, and its
``_throttle_s`` key a pause before each dispatch).
``train_cuda``: the same with every rank on ``cuda:0`` (ranks sharing
the card over gloo).  ``cli``: ``python -m fast_tffm_tpu_torch.cli`` with the arguments in
``DIR/cli.json`` plus the multi-rank flags (the CLI joins the group).
``collectives``: on ``cuda`` (ranks sharing one GPU over gloo), hold
``psum``, ``all_gather`` and ``gather`` over each axis of a 2-rank mesh
to the sums and concatenations computed locally.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.parallel import mesh as mesh_lib
from fast_tffm_tpu_torch.train import (
    dense, dist, optimizers, shardmap_step, sparse, tiered,
)
from fast_tffm_tpu_torch.train.loop import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 150
_OPT_KEYS = {"adagrad": ("acc_w0", "acc_table"),
             "ftrl": ("z_w0", "z_table", "n_w0", "n_table"), "sgd": ()}


def _block(z, s, mesh, device):
    """Global batch ``s`` of the npz ``z``: this rank's data block of
    it, on ``device``."""
    block, blocks = mesh_lib.data_partition(mesh)
    glob = [z[f"b{s}_{f}"] for f in Batch._fields[:5]]
    b_local = glob[0].shape[0] // blocks
    part = slice(block * b_local, (block + 1) * b_local)
    return sparse.to_device(Batch(*(a[part] for a in glob)), device)


def _steps(workdir, rank, device="cpu"):
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    for i, case in enumerate(cases):
        cfg = FmConfig(**case["cfg"])
        mesh = mesh_lib.make_mesh(cfg)
        z = np.load(os.path.join(workdir, f"case{i}.npz"))
        model = FmModel(torch.tensor(float(z["w0"]), device=device),
                        torch.from_numpy(np.array(weights.shard_rows(
                            z["table"], mesh, rank))).to(device))
        if sparse.supports_sparse(cfg) and cfg.sparse_update:
            keys = _OPT_KEYS[cfg.optimizer]
            opt = tuple(
                torch.from_numpy(np.array(
                    weights.shard_rows(z[k], mesh, rank)
                    if k.endswith("table") else z[k], np.float32)).to(device)
                for k in keys
            )
            opt = (sparse.SparseAdagradState(*opt)
                   if cfg.optimizer == "adagrad"
                   else sparse.SparseFtrlState(*opt)
                   if cfg.optimizer == "ftrl" else ())
            step = shardmap_step.sparse_step_shardmap
        else:
            opt = optimizers.init_dense_opt_state(cfg, model)
            keys = getattr(opt, "_fields", ())
            step = dense.dense_step_sharded
        applied = []
        apply_dense = dense.apply_dense

        def spy(cfg, model, opt_state, dw0, dtable):
            applied.append((model.w0.detach().clone(),
                            model.table.detach().clone(), dw0.clone(),
                            dtable.clone()))
            apply_dense(cfg, model, opt_state, dw0, dtable)

        dense.apply_dense = spy
        try:
            scores = [step(cfg, model, opt, _block(z, s, mesh, device),
                           mesh).cpu().numpy() for s in range(case["steps"])]
        finally:
            dense.apply_dense = apply_dense
        out = {"scores": np.stack(scores), "table": model.table.detach(),
               "w0": model.w0.detach()}
        if applied:
            out.update(zip(("w0_before", "table_before", "dw0", "dtable"),
                           (torch.stack(t) for t in zip(*applied))))
        out.update(zip(keys, opt))
        np.savez(os.path.join(workdir, f"out{i}_{rank}.npz"),
                 **{k: np.asarray(v.cpu()) if torch.is_tensor(v)
                    else np.asarray(v) for k, v in out.items()})


def _trainer_steps(workdir, rank):
    with open(os.path.join(workdir, "trainer.json")) as f:
        cases = json.load(f)
    for i, case in enumerate(cases):
        trainer = Trainer(FmConfig(**case["cfg"]), device="cpu")
        z = np.load(os.path.join(workdir, case["batches"] + ".npz"))
        first, steps = case["first"], case["steps"]
        for s in range(first, first + steps):
            trainer.train_step(
                Batch(*(a.numpy() for a in _block(z, s, trainer.mesh,
                                                  "cpu")[:5])))
        trainer.save(steps)
        with open(os.path.join(workdir, f"trainer{i}_{rank}.json"),
                  "w") as f:
            json.dump(trainer.global_metrics(trainer.metrics), f)


def _train(workdir, rank, device="cpu"):
    with open(os.path.join(workdir, "train.json")) as f:
        runs = json.load(f)
    exact = tiered.EXACT_BYTES_MAX
    for i, kw in enumerate(runs):
        tiered.EXACT_BYTES_MAX = kw.pop("_exact_bytes_max", exact)
        evaluate = kw.pop("_evaluate", None)
        ports = kw.pop("_status_ports", None)  # one per rank
        if ports:
            kw["status_port"] = ports[rank]
        throttle = kw.pop("_throttle_s", 0.0)  # a pause before each dispatch
        trainer = Trainer(FmConfig(**kw), device=device)
        if throttle:
            real = trainer.dispatch

            def slow(sb, pause=None, real=real):
                time.sleep(throttle)
                return real(sb, pause)

            trainer.dispatch = slow
        result = trainer.train()
        if evaluate:
            try:
                result["evaluate"] = trainer.evaluate(evaluate)
            except RuntimeError as e:
                result["evaluate_error"] = str(e)
        with open(os.path.join(workdir, f"train{i}_{rank}.json"), "w") as f:
            json.dump(result, f)


def _collectives(workdir, rank):
    dev = torch.device("cuda", 0)
    for shape, axis in (((2, 1), mesh_lib.DATA_AXIS),
                        ((1, 2), mesh_lib.MODEL_AXIS)):
        mesh = mesh_lib.make_mesh(FmConfig(mesh_data=shape[0],
                                           mesh_model=shape[1]))
        assert mesh.backend == "gloo", mesh.backend
        mine = [torch.arange(12, dtype=torch.float32, device=dev)
                .reshape(4, 3) * (r + 1) for r in range(2)]
        got = mesh_lib.psum(mine[rank].clone(), axis, mesh)
        assert got.device == dev
        assert torch.equal(got, mine[0] + mine[1]), (axis, got)
        ids = [torch.tensor([r, 7, r + 3], dtype=torch.int32, device=dev)
               for r in range(2)]
        gathered = mesh_lib.all_gather(ids[rank], axis, mesh)
        assert gathered.device == dev
        assert torch.equal(gathered, torch.cat(ids)), (axis, gathered)
        first = mesh_lib.gather(ids[rank], axis, mesh)
        if rank == 0:
            assert first.device == dev
            assert torch.equal(first, torch.cat(ids)), (axis, first)
        else:
            assert first is None
    with open(os.path.join(workdir, f"collectives_{rank}.ok"), "w") as f:
        f.write("ok\n")


def run_ranks(mode, world, workdir):
    """Run ``world`` ranks of this script in ``mode``; fail (killing
    them all) when one exits non-zero or RANK_TIMEOUT_S passes."""
    repo = os.path.dirname(HERE)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    url = f"file://{workdir}/rendezvous"
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, url,
             str(world), str(r), str(workdir)], cwd=repo, env=env,
            stdout=log, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"ranks still running after {RANK_TIMEOUT_S} s"
            time.sleep(0.05)
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
        bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed is None and bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {r} ---\n{log.read()[-3000:]}")
            log.close()
    assert failed is None, failed + "\n" + "\n".join(text)


def main():
    mode, url, world, rank, workdir = sys.argv[1:6]
    # A rank still running near the deadline writes every thread's stack
    # into its log, which run_ranks prints.
    faulthandler.dump_traceback_later(RANK_TIMEOUT_S - 15)
    torch.set_num_threads(1)
    if mode == "cli":
        from fast_tffm_tpu_torch import cli

        with open(os.path.join(workdir, "cli.json")) as f:
            argv = json.load(f)
        sys.exit(cli.main(argv + ["--coordinator", url, "--num_processes",
                                  world, "--process_id", rank]))
    run = {"step": _steps, "train": _train, "collectives": _collectives,
           "train_cuda": lambda w, r: _train(w, r, dev),
           "step_cuda": lambda w, r: _steps(w, r, dev),
           "trainer": _trainer_steps}
    on_card = mode in ("collectives", "train_cuda", "step_cuda")
    dev = dist.initialize(url, int(world), int(rank),
                          device="cuda:0" if on_card else "cpu")
    try:
        run[mode](workdir, int(rank))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
