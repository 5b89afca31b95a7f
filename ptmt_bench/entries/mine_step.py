"""Entry ``mine_step``: one rank's sharded mining step.

Set-up generates the configuration's graph from the seed and cuts the
rank's zone batch from it, each by the data module the configuration's
``generator`` and ``batch`` entries name (``ptmt_bench/data``); it
copies the batch to the device once (it stays resident, as a rank's
block of zones does), starts a one-rank process group and
``DeviceMesh`` (NCCL on the card, gloo on the CPU; its ``FileStore`` in
a directory made under ``TMPDIR`` and removed at the end), and builds the step through the program's own arch
config: ``configs.ptmt.mining_workload`` on ``configs.ptmt.MiningConfig``
with the configuration's fields, which calls
``distributed.mining.make_mine_fn``.  Every call runs the step on the
resident batch and reads its overflow flag, which waits for the step's
last operation, as the program's own driver (``run_mine_fn``) does.

Checked: each sampled step's ``CodeCounts`` against the reference's
signed table of the batch, and the sum of the overflow flags of all the
window's steps.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from ptmt_bench.reference import compare, ptmt_ref
from ptmt_bench.roofline import zone_scan


class Session:
    def __init__(self, config: dict, *, seed, device, traced: bool,
                 registry):
        self.config = config
        self.registry = registry
        self.seed = seed
        self.device = torch.device(device)
        self.overflow = 0
        self._store_dir = None

    def setup(self) -> None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs import ptmt

        shape = self.config["shape"]
        mining = self.config["mining"]
        gen = dict(self.config["generator"])
        graph = self.registry.data(gen.pop("name")).generate(
            seed=self.seed, **gen)
        batch = dict(self.config["batch"])
        self.batch = self.registry.data(batch.pop("name")).build(
            graph, seed=[self.seed, 1], delta=mining["delta"],
            l_max=mining["l_max"], omega=mining["omega"],
            n_zones=shape["n_zones"], e_cap=shape["e_cap"], **batch)
        self.work_per_call = int(self.batch[3].sum())
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.set_device(self.device)
        self._store_dir = tempfile.mkdtemp(prefix="ptmt_bench_store_")
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            store=dist.FileStore(os.path.join(self._store_dir, "store"), 1),
            rank=0, world_size=1)
        mesh = init_device_mesh(self.device.type, (1,),
                                mesh_dim_names=tuple(self.config["mesh"]))
        cfg = ptmt.MiningConfig(name=self.config["name"],
                                **self.config["mining"])
        step_shape = ptmt.MiningShape(shape["name"], shape["n_zones"],
                                      shape["e_cap"])
        self.step = ptmt.mining_workload(cfg, step_shape, mesh).fn
        self.tensors = [torch.as_tensor(x, device=self.device)
                        for x in self.batch]

    def call(self):
        counts, overflow = self.step(*self.tensors)
        self.overflow += int(overflow)
        return counts

    def spans(self) -> list:
        return []

    def free(self) -> None:
        import torch.distributed as dist

        del self.step, self.tensors
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kept: list):
        """``(numbers compared, counts, roofline context)``."""
        mining = self.config["mining"]
        l_max = mining["l_max"]
        keys, counts, steps, node_steps = ptmt_ref.zone_counts(
            *self.batch, delta=mining["delta"], l_max=l_max,
            device=self.device)
        wrong = None
        for _, out in kept:
            mask = out.unique_mask.cpu().numpy()
            got = compare.table_mismatch(
                compare.limb_keys(out.codes.cpu().numpy()[mask], l_max),
                out.counts.cpu().numpy()[mask], keys, counts)
            wrong = max(wrong or 0, got)
        numbers = {"codes_wrong": wrong, "overflow": self.overflow}
        valid = self.batch[3]
        info = {"steps_checked": len(kept), "codes": int((counts != 0).sum())}
        context = {"b3": zone_scan.zone_scan_work(
            valid.size, int(np.count_nonzero(valid)), int(steps.sum()),
            int(node_steps.sum()), l_max)}
        return numbers, info, context
