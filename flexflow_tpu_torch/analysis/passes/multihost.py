"""multihost-order: the static deadlock detector.

PyTorch counterpart of ``flexflow_tpu/analysis/passes/multihost.py``.
The per-host programs are optimized-HLO texts, read as the JAX package
reads them; the port runs one process, so with fewer than two programs
the pass skips with the reference's reason.

Multi-controller SPMD's cardinal rule: every process must issue the
same collectives in the same order, or the fleet deadlocks with each
host parked in a different all-reduce (the failure takes a wall-clock
timeout to even notice on real pods). Per-host programs are identical
by construction when every host runs the same compiled step — but the
moment anything host-dependent leaks into compilation (host-conditional
graph edits, per-host shape differences from a skewed dataloader, a
rank-gated layer) the orders diverge.

This pass takes the per-host optimized-HLO texts
(``LintContext.hlo_per_host``, e.g. collected by the multihost dryrun)
and compares the ordered collective sequences:

* FFL501  two hosts disagree on the k-th collective (kind or shape) —
          a guaranteed deadlock/corruption at step time;
* FFL502  a host's program has a different collective COUNT (one host
          will wait forever on a collective its peers never enter).

On a multi-slice deployment (``LintContext.slice_of_host`` maps each
program to its slice) the comparison is hierarchical, matching the
fabric the collectives rendezvous over: FFL501/502 are checked WITHIN
each slice (against the slice's first host, diagnostics name the
slice), and the slice leaders are then compared across the DCN:

* FFL503  two slices' leader programs diverge (order, kind, shape, or
          count) — the cross-slice collective (the DCN gradient sync)
          deadlocks even though every slice is internally consistent.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error
from flexflow_tpu_torch.obs.inspect import COLLECTIVE_KINDS

_SEQ_RE = re.compile(
    # "%name = SHAPE opcode(" — SHAPE is a typed array (with optional
    # layout braces) or a tuple; requiring the "= SHAPE" prefix keeps
    # LHS names like %all-reduce.58 from matching
    r"\S+\s*=\s*((?:\w+\[[^\]]*\](?:\{[^}]*\})?|\([^)]*\)))\s*"
    r"(" + "|".join(COLLECTIVE_KINDS) + r")(-start|-done)?[.\d]*\(")


def collective_sequence(hlo_text: str) -> List[Tuple[str, str]]:
    """Ordered (kind, shape) list of collectives in an HLO module, in
    program order. Async -start/-done pairs count once (the -start is
    where the host enters the rendezvous)."""
    seq: List[Tuple[str, str]] = []
    for line in hlo_text.splitlines():
        m = _SEQ_RE.search(line)
        if not m or m.group(3) == "-done":
            continue
        seq.append((m.group(2), m.group(1).strip()))
    return seq


class MultihostOrderPass:
    name = "multihost-order"

    def run(self, ctx) -> List[Diagnostic]:
        texts = ctx.hlo_per_host
        if not texts or len(texts) < 2:
            from flexflow_tpu_torch.analysis.orchestrator import SkipPass
            raise SkipPass("needs >= 2 per-host HLO programs "
                           "(hlo_per_host); single-program runs are "
                           "order-consistent by construction")
        diags: List[Diagnostic] = []
        seqs = [collective_sequence(t) for t in texts]
        slices = getattr(ctx, "slice_of_host", None)
        if slices and len(slices) == len(seqs):
            # hierarchical (multi-slice) comparison: within-slice order
            # per slice, then the slice leaders across the DCN
            groups = {}
            for host, sl in enumerate(slices):
                groups.setdefault(sl, []).append(host)
            for sl, hosts in sorted(groups.items()):
                lead = hosts[0]
                for host in hosts[1:]:
                    diags.extend(self._compare(
                        seqs[lead], seqs[host],
                        f"host {lead} (slice {sl})",
                        f"host {host} (slice {sl})",
                        "FFL502", "FFL501"))
            leaders = [hosts[0] for _, hosts in sorted(groups.items())]
            for sl, host in zip(sorted(groups)[1:], leaders[1:]):
                diags.extend(self._compare(
                    seqs[leaders[0]], seqs[host],
                    f"slice {sorted(groups)[0]} leader (host "
                    f"{leaders[0]})",
                    f"slice {sl} leader (host {host})",
                    "FFL503", "FFL503"))
            return diags
        ref = seqs[0]
        for host, seq in enumerate(seqs[1:], start=1):
            diags.extend(self._compare(ref, seq, "host 0", f"host {host}",
                                       "FFL502", "FFL501"))
        return diags

    @staticmethod
    def _compare(ref, seq, ref_name: str, name: str, count_rule: str,
                 order_rule: str) -> List[Diagnostic]:
        """FFL50x diff of two collective sequences: one count
        diagnostic and/or the first order divergence."""
        diags: List[Diagnostic] = []
        cross = count_rule == "FFL503"
        if len(seq) != len(ref):
            diags.append(error(
                count_rule,
                f"{name} issues {len(seq)} collectives, {ref_name} "
                f"issues {len(ref)} — a host will block forever on "
                f"a rendezvous its peers never enter",
                hint=("cross-slice programs must agree for the DCN "
                      "collectives to rendezvous — diff the slice "
                      "leaders' programs" if cross else
                      "diff the per-host programs; something "
                      "host-dependent leaked into compilation")))
        for k, (a, b) in enumerate(zip(ref, seq)):
            if a != b:
                diags.append(error(
                    order_rule,
                    f"collective order diverges at position {k}: "
                    f"{ref_name} runs {a[0]} {a[1]}, {name} runs "
                    f"{b[0]} {b[1]}",
                    hint=("the cross-slice gradient sync deadlocks "
                          "even with every slice internally "
                          "consistent" if cross else
                          "mismatched collective sequences deadlock "
                          "(or silently corrupt when kinds pair up "
                          "wrong) — per-host programs must be "
                          "identical")))
                break  # first divergence per pair is enough
        return diags
