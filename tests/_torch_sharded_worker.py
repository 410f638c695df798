"""One rank of a multi-rank run of the port, for
``tests/test_torch_sharded.py`` and ``tests/test_torch_gpu.py`` (imports
torch and the port only), and :func:`run_ranks`, which starts them.

    python tests/_torch_sharded_worker.py MODE INIT_URL WORLD RANK DIR

``step``: for every case in ``DIR/cases.json`` (inputs in
``DIR/case<i>.npz``: the full initial table and optimizer tables, the
global batches), run ``sparse_step_shardmap`` on this rank's model shard
and data block and write ``DIR/out<i>_<rank>.npz`` (its scores, shards
and w0).  ``train``: run ``Trainer.train()`` for each config in
``DIR/train.json`` and write its result to ``DIR/train<i>_<rank>.json``.
``cli``: ``python -m fast_tffm_tpu_torch.cli`` with the arguments in
``DIR/cli.json`` plus the multi-rank flags (the CLI joins the group).
``collectives``: on ``cuda`` (ranks sharing one GPU over gloo), hold
``psum``, ``all_gather`` and ``gather`` over each axis of a 2-rank mesh
to the sums and concatenations computed locally.
"""

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
from fast_tffm_tpu_torch.train import dist, shardmap_step, sparse
from fast_tffm_tpu_torch.train.loop import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 150
_OPT_KEYS = {"adagrad": ("acc_w0", "acc_table"),
             "ftrl": ("z_w0", "z_table", "n_w0", "n_table"), "sgd": ()}


def _steps(workdir, rank):
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    for i, case in enumerate(cases):
        cfg = FmConfig(**case["cfg"])
        mesh = mesh_lib.make_mesh(cfg)
        z = np.load(os.path.join(workdir, f"case{i}.npz"))
        model = FmModel(torch.tensor(float(z["w0"])), torch.from_numpy(
            np.array(weights.shard_rows(z["table"], mesh, rank))))
        keys = _OPT_KEYS[cfg.optimizer]
        opt = tuple(
            torch.from_numpy(np.array(
                weights.shard_rows(z[k], mesh, rank) if k.endswith("table")
                else z[k], np.float32))
            for k in keys
        )
        opt = (sparse.SparseAdagradState(*opt) if cfg.optimizer == "adagrad"
               else sparse.SparseFtrlState(*opt) if cfg.optimizer == "ftrl"
               else ())
        block, blocks = mesh_lib.data_partition(mesh)
        scores = []
        for s in range(case["steps"]):
            glob = [z[f"b{s}_{f}"] for f in Batch._fields[:5]]
            b_local = glob[0].shape[0] // blocks
            part = slice(block * b_local, (block + 1) * b_local)
            batch = sparse.to_device(Batch(*(a[part] for a in glob)), "cpu")
            scores.append(shardmap_step.sparse_step_shardmap(
                cfg, model, opt, batch, mesh).numpy())
        out = {"scores": np.stack(scores), "table": model.table.detach(),
               "w0": model.w0.detach()}
        out.update(zip(keys, opt))
        np.savez(os.path.join(workdir, f"out{i}_{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})


def _train(workdir, rank):
    with open(os.path.join(workdir, "train.json")) as f:
        runs = json.load(f)
    for i, kw in enumerate(runs):
        result = Trainer(FmConfig(**kw), device="cpu").train()
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
    torch.set_num_threads(1)
    if mode == "cli":
        from fast_tffm_tpu_torch import cli

        with open(os.path.join(workdir, "cli.json")) as f:
            argv = json.load(f)
        sys.exit(cli.main(argv + ["--coordinator", url, "--num_processes",
                                  world, "--process_id", rank]))
    run = {"step": _steps, "train": _train, "collectives": _collectives}
    dist.initialize(url, int(world), int(rank),
                    device="cuda:0" if mode == "collectives" else "cpu")
    try:
        run[mode](workdir, int(rank))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
