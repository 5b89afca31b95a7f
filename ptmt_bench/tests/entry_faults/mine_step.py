"""The faults of entry ``mine_step``, planted under its timed path, each
breaking the program where it produces its answer, the way a wrong
optimisation would:

* ``answer``: one count of the answer altered where it is produced, in
  the merge's gathered counts;
* ``half``: half of the batch left out, the second half of the rank's
  zones;
* ``unchanged``: the step returns its state unchanged, the empty table
  it starts from, as if the scan never ran.

The exchange between chips cannot be left out of a one-rank cell: on one
rank the all-gather is the identity.
"""

from __future__ import annotations

#: the checks each fault has to break
BREAKS = {"answer": ["codes_wrong"], "half": ["codes_wrong"],
          "unchanged": ["codes_wrong"]}


def plant(fault: str) -> None:
    import torch

    from repro_torch.core import aggregation, encoding, executor
    from repro_torch.distributed import mining

    if fault == "answer":
        gather = mining.all_gather_tiled

        def altered_gather(x, group):
            out = gather(x, group)
            if out.dim() == 1:          # the counts, not the codes
                out = out.clone()
                out[out.nonzero()[0]] += 1
            return out

        mining.all_gather_tiled = altered_gather
    elif fault in ("half", "unchanged"):
        partial = executor.MiningExecutor.scan_aggregate_partial

        def partial_part(self, u, v, t, valid, signs):
            if fault == "half":
                z = u.shape[0] // 2
                return partial(self, u[:z], v[:z], t[:z], valid[:z],
                               signs[:z])
            return (aggregation.empty_counts(
                u.shape[0] * u.shape[1], encoding.n_limbs(self.l_max),
                device=u.device),
                torch.zeros((), dtype=torch.int32, device=u.device))

        executor.MiningExecutor.scan_aggregate_partial = partial_part
    else:
        raise ValueError(f"unknown fault {fault!r}")
