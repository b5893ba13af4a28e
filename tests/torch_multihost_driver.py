"""One process of a multi-process run of the PyTorch port, joined over
``torch.distributed`` (gloo) on a loopback address; the counterpart of
``tests/multihost_driver.py``.  ``tests/test_torch_multihost.py`` starts N
of them as separate interpreters and holds the N-process SAM against the
1-process SAM byte for byte.

Usage:
    python torch_multihost_driver.py <pid> <nprocs> <port> <out.sam>
        [exact|sharded|interval|flagwait] [--device cpu|cuda] [--n-interval S]

mode "exact" (default): a 20 kb genome (seed 21), 32 reads of 40 bases
(seed 22) through ``multihost.exact_align``: each process passes only its
slice through ``make_global_batch``, runs ``exact_interval_search`` +
``locate_hits`` on both strands and ``gather_to_host``; process 0 writes
the SAM.

mode "sharded": ``ShardedAligner(k=2, n_interval=S, seed_j=8)`` (S = 2
unless ``--n-interval``) on a 100 kb genome (seed 31): a batch of 100 bp
reads with indels and a batch of 30 bp reads, both on the seed path
(pieces of 10 bases and more); each maps >= 90%; process 0 writes the SAM.  With several processes
each holds S / P of the shards and maps the others'.

mode "interval" (BASELINE config 5's layout): the "sharded" run without
the seed table (the FM path; process 0 writes ``<out.sam>.fm.sam``) and
with it, then in every process the exact search
(``make_sharded_exact_search`` with the data axis over the interval
groups: every process of a group its group's slice of
``exact_search_reads``) under the psum, ring and fused merges, written to
``<out.sam>.<pid>.npz``; and ``<out.sam>.<pid>.json``: the route, every
process's host, the shards this process holds, its interval group's
members, the rows of the batch its group searched, its card and the card
of each shard, the aligners' merges and the exact search's by route, each
sharded table's bytes here against the stacked table's and whether it is
a plain tensor, whether text shards were made, on the card the launches
of the banded DP's two entries and the fused table entry, the ring
merge's inbox shape, chunk-steps and the elements of its row that differ
from the held shards' partials, and what this process reads through its
map of every shard after each process has changed a word of its own
shards (the mapped peers are not copies).
Where an interval group spans hosts (start the processes with their own
``GROUP_RANK``, ``launch(..., nodes=...)``), the collective route:
``parallel.peer.share`` is replaced by a function that raises, the
exact search runs under psum alone, and the errors that the ring and
fused merges raise are recorded.

mode "flagwait" (the card only, a card a process): the ring merge's
flag-wait entry over every process's inbox and flag words, mapped through
``parallel.peer``: four merges (int32 65,536 and 7, float32 4,099 and
65,536), each process's partial in its row of its own inbox, each merge
against ``ring_psum_plain`` of every process's partial, and each inbox
holding every process's row after it (the pushes landed); then process 0
waits for an epoch no other process has reached, times out and runs two
more merges, and the others, arriving after that, must fail at once.
``<out.sam>.<pid>.json``: the cards, the merges' equality, the pushes,
the launches, the seconds each failure took, which peers poisoned every
flag word of this process and whether ``check_flag_wait`` raised.

The device defaults to cuda (process p on ``cuda:p % device_count``).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def launch(nprocs: int, out, *args: str, driver=__file__, timeout: float = 300,
           nodes=None) -> list[str]:
    """Run ``nprocs`` interpreters of ``driver`` (this file by default) as
    processes 0..nprocs-1 of one group on a free loopback port, the checkout
    on their ``PYTHONPATH``; every one must exit 0 within ``timeout`` of
    the start (each is cut off at its own deadline).  ``nodes`` gives each
    process its node rank (``GROUP_RANK``, as torchrun sets it), declaring
    the hosts.  Returns their outputs in process order."""
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "GROUP_RANK")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, str(driver), str(pid), str(nprocs), port, str(out),
                          *args], env=env if nodes is None else {**env, "GROUP_RANK": str(nodes[pid])},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nprocs)
    ]
    deadline = time.monotonic() + timeout
    texts = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"{driver} exited {p.returncode}: {text[-3000:]}")
            texts.append(text)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return texts


def main(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("pid", type=int)
    p.add_argument("nprocs", type=int)
    p.add_argument("port")
    p.add_argument("out")
    p.add_argument("mode", nargs="?", choices=["exact", "sharded", "interval", "flagwait"],
                   default="exact")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--n-interval", type=int, default=2)
    a = p.parse_args(argv)
    pid, nprocs, port, out, mode, device = a.pid, a.nprocs, a.port, a.out, a.mode, a.device

    import torch

    # several of these share the machine's cores with other test workers
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from genome_weaver_align_tpu_torch.parallel import multihost as mh

    mh.initialize_distributed(f"127.0.0.1:{port}", nprocs, pid)
    assert mh.process_count() == nprocs and mh.process_index() == pid
    if nprocs > 1:
        assert torch.distributed.get_backend() == "gloo"
    if device == "cuda":
        device = f"cuda:{pid % torch.cuda.device_count()}"
    try:
        if mode == "exact":
            exact_main(pid, out, torch.device(device))
        elif mode == "flagwait":
            flagwait_main(pid, nprocs, out, torch.device(device))
        elif mode == "interval":
            interval_main(pid, out, torch.device(device), a.n_interval)
        else:
            sharded_main(pid, out, torch.device(device), a.n_interval).close()
    finally:
        if nprocs > 1:
            torch.distributed.destroy_process_group()
    print(f"proc {pid}/{nprocs}: OK", flush=True)


def exact_main(pid, out, device):
    import numpy as np

    from genome_weaver_align_tpu_torch.index.files import Genome, build_genome_index
    from genome_weaver_align_tpu_torch.models import exact
    from genome_weaver_align_tpu_torch.ops import rank
    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.utils import sam, simulate
    from genome_weaver_align_tpu_torch.utils.fasta import Contig

    # every process builds the same tiny index (in production each loads
    # the serialized index)
    g = simulate.random_genome(20_000, seed=21)
    gi = build_genome_index(Genome.from_contigs([Contig("c1", g)]), sample_rate=16)
    dfm = rank.from_host(gi.fwd, device)

    B, L = 32, 40
    reads, _, _, _ = simulate.simulate_reads_array(g, B, L, seed=22, max_subs=0)
    layout = pmesh.make_layout(mh.process_count(), 1, device)
    gpos, gstr = mh.exact_align(dfm, layout, reads.astype(np.int32), np.full(B, L, np.int32))
    assert gpos.shape == (B,)

    if pid == 0:
        recs = exact.sam_records(gi.genome, [f"r{i}" for i in range(B)], reads, gpos, gstr)
        sam.write_sam(out, sam.header(gi.genome.names, gi.genome.lengths), recs)


def sharded_batches(g):
    """The sharded modes' two batches of 64 reads: (tag, reads) with reads
    a list of (name, codes), 100 bp reads with <= 1 substitution and an
    indel in 15% (seed 32), and 30 bp reads with <= 1 substitution (seed
    33)."""
    import numpy as np

    from genome_weaver_align_tpu_torch.utils import simulate

    out = []
    for tag, (L, max_subs, indel_frac, seed) in (
        ("long", (100, 1, 0.15, 32)),  # <= 1 sub + <= 1 indel: within k = 2
        ("short", (30, 1, 0.0, 33)),
    ):
        B = 64
        rarr, _, _, _ = simulate.simulate_reads_array(
            g, B, L, seed=seed, max_subs=max_subs, indel_frac=indel_frac)
        out.append((tag, [(f"{tag}{i}", rarr[i].astype(np.uint8)) for i in range(B)]))
    return out


def sharded_main(pid, out, device, n_interval=2, seed_table=True):
    """ShardedAligner across processes on a 100 kb genome with planted
    substitutions and indels (``sharded_batches``): with the seed table
    (seed_j = 8) both batches take the seed-table path, without it the FM
    path.  Every process holds the whole index on the host and its own
    shards on ``device``.  -> the aligner (close it: a collective)."""
    from genome_weaver_align_tpu_torch.index.files import Genome, build_genome_index
    from genome_weaver_align_tpu_torch.index.seedtable import build_seed_table
    from genome_weaver_align_tpu_torch.parallel.sharded_pipeline import ShardedAligner
    from genome_weaver_align_tpu_torch.utils import sam
    from genome_weaver_align_tpu_torch.utils.fasta import Contig, Read

    g = sharded_genome()
    gi = build_genome_index(Genome.from_contigs([Contig("c1", g)]), sample_rate=16)
    kw = {}
    if seed_table:
        kw = {"seed_table": build_seed_table(g, 8), "seed_j": 8}
    al = ShardedAligner(gi, k=2, n_interval=n_interval, max_hits=8, device=device, **kw)

    recs = []
    for tag, batch in sharded_batches(g):
        reads = [Read(name, codes) for name, codes in batch]
        hits = al.align_batch(reads)
        B = len(reads)
        assert sum(h is not None for h in hits) >= int(0.9 * B), tag
        recs.extend(al.to_sam(reads, hits))

    if pid == 0:
        sam.write_sam(out, al.sam_header(), recs)
    if device.type == "cuda":
        from genome_weaver_align_tpu_torch.ops import dp_cuda

        print(f"windows-entry launches {dp_cuda.banded_edit_distance_cuda.launches}")
    return al


EXACT_B, EXACT_L = 48, 30


def sharded_genome():
    """The 100 kb genome of the sharded and interval modes."""
    from genome_weaver_align_tpu_torch.utils import simulate

    return simulate.random_genome(100_000, seed=31)


def exact_search_reads(g):
    """``EXACT_B`` reads of ``EXACT_L`` bases from the genome (seed 34),
    lengths down to ``EXACT_L`` - 6, every 5th with a base changed (most of
    those have no exact match) -> (reads, lengths) int32."""
    import numpy as np

    rng = np.random.default_rng(34)
    starts = rng.integers(0, g.size - EXACT_L, size=EXACT_B)
    reads = g[starts[:, None] + np.arange(EXACT_L)[None, :]].astype(np.int32)
    reads[::5, 3] = (reads[::5, 3] + 1) % 4
    lengths = rng.integers(EXACT_L - 6, EXACT_L + 1, size=EXACT_B).astype(np.int32)
    return reads, lengths


def interval_main(pid, out, device, n_interval):
    """The interval mode (see the module's docstring): the FM path and the
    seed path, then the exact search under each merge in every process, and
    what this process holds and sees of the shard tables.  Where an
    interval group spans hosts (the collective route) nothing may be
    mapped, so ``peer.share`` raises if anything calls it, and the ring and
    fused merges must refuse."""
    import json

    import numpy as np
    import torch

    from genome_weaver_align_tpu_torch.parallel import mesh as pmesh
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.parallel import peer
    from genome_weaver_align_tpu_torch.parallel import sharded_index as si

    collective = pmesh.make_layout(mh.process_count(), n_interval, device).collective
    if collective:
        def no_share(*_a, **_k):
            raise AssertionError("peer.share was called on the collective route")

        peer.share = no_share
    sharded_main(pid, f"{out}.fm.sam", device, n_interval, seed_table=False).close()
    al = sharded_main(pid, out, device, n_interval)
    lay = al.layout
    S = lay.n_interval
    layout = pmesh.make_layout(lay.groups, S, device)  # a group's slice each
    reads, lengths = exact_search_reads(sharded_genome())
    r, ln, B = pmesh.shard_reads(layout, reads, lengths)
    assert B % layout.groups == 0  # no padding: each group's rows are its slice
    first = layout.data_index * r.shape[0]
    facts = {"collective": lay.collective, "mapped": lay.mapped,
             "hosts": [mh.host_of(q) for q in range(lay.process_count)],
             "held": list(lay.held), "owners": list(lay.owners), "group": list(lay.group_ranks),
             "data": [lay.data_procs, lay.data_index], "text_shards": al.tx is not None,
             "rows": [first, first + r.shape[0]], "card": mh.card(),
             "cards": list(al.sh.bwt_blocks.cards) if isinstance(al.sh.bwt_blocks, peer.Shards)
             else None, "aligner_routes": dict(si.CROSS_MERGES), "bytes": {}, "plain": {},
             "refused": {}}
    for key in si.CROSS_MERGES:
        si.CROSS_MERGES[key] = 0
    res = {}
    # the ring merge's inbox rows: after each chunk-step this process's row
    # must hold its held shards' lo and hi partials
    facts["ring"] = {"inbox": None, "steps": 0, "bad": 0}
    ring_step = si._RingSlots.step

    def checked_step(slots, own, codes, lo, hi):
        got = ring_step(slots, own, codes, lo, hi)
        row = slots.inboxes[(slots.turn - 1) % 2][slots.me][slots.me]
        want = torch.stack([si.local_occ_codes(own, codes, k).sum(0, dtype=torch.int32)
                            for k in (lo, hi)])
        facts["ring"]["inbox"] = list(slots.inboxes[0][slots.me].shape)
        facts["ring"]["steps"] += 1
        facts["ring"]["bad"] += int((row.cpu() != want.cpu()).sum())
        return got

    si._RingSlots.step = checked_step
    for merge in ("psum", "ring", "fused"):
        if lay.collective and merge != "psum":  # they read the other members' memory
            try:
                si.make_sharded_exact_search(layout, EXACT_L, al.sh, merge=merge, microbatch=2)
            except ValueError as e:
                facts["refused"][merge] = str(e)
            continue
        fn = si.make_sharded_exact_search(layout, EXACT_L, al.sh, merge=merge, microbatch=2)
        for key, v in zip(("lo", "hi", "pos"), fn(al.sh, r, ln)):
            res[f"{merge}_{key}"] = v.cpu().numpy()
    si._RingSlots.step = ring_step
    np.savez(f"{out}.{pid}.npz", **res)
    facts["routes"] = dict(si.CROSS_MERGES)  # the exact search's merges, by route

    # each table's bytes here against the stacked table's (None where the
    # collective route keeps no stacked shape: the seed table's shards)
    tables = {**{f: getattr(al.sh, f) for f in si._TABLES}, "offsets": al.sst.offsets,
              "positions": al.sst.positions}
    if al.tx is not None:
        tables["words"] = al.tx.words
    stacked = si.shard_fm_index(al.gi.fwd, S)
    for f, t in tables.items():
        held = t.held if isinstance(t, peer.Shards) else t
        whole = (int(np.prod(t.shape)) * 4 if lay.mapped
                 else getattr(stacked, f).size * 4 if f in si._TABLES else None)
        facts["bytes"][f] = [held.numel() * 4, whole]
        facts["plain"][f] = type(t) is torch.Tensor
    facts["seed_rows"] = [tuple(t.shape) for t in (al.sst.offsets, al.sst.positions)]
    if device.type == "cuda":  # every run above, this process's launches
        from genome_weaver_align_tpu_torch.ops import dp_cuda, ring_cuda

        torch.cuda.synchronize(device)
        facts["launches"] = {"text entry": dp_cuda.banded_edit_distance_text_cuda.launches,
                             "windows entry": dp_cuda.banded_edit_distance_cuda.launches,
                             "fused table entry": ring_cuda.fused_occ_cuda.launches}
    if device.type == "cuda" and lay.mapped:  # the sharded kernels on the mapped shards
        from genome_weaver_align_tpu_torch.ops import locate_cuda
        from genome_weaver_align_tpu_torch.parallel import sharded_pipeline as sp

        rows = torch.arange(al.gi.fwd.n + 1, dtype=torch.int32, device=al.device)
        before = locate_cuda.locate_sharded_cuda.launches
        got = si.locate(al.sh, rows)
        facts["locate_launches"] = locate_cuda.locate_sharded_cuda.launches - before
        facts["locate_equal"] = bool(torch.equal(got, si.locate_plain(al.sh, rows)))
        rd, ld = r.to(al.device), ln.to(al.device)
        facts["pieces_equal"] = all(torch.equal(a, b) for a, b in zip(
            sp.sharded_piece_search(al.sh, rd, ld, 3, EXACT_L),
            sp.sharded_piece_search_plain(al.sh, rd, ld, 3, EXACT_L)))
        k = rows[: 4096] * 7 % (al.gi.fwd.n + 2)
        facts["fused_equal"] = bool(torch.equal(si.fused_occ(al.sh, k % 4, k),
                                                si.fused_occ_plain(al.sh, k % 4, k)))
        pos = al.sst.positions  # rows of mapped shards, read on this card
        idx = (rows[: 4096] % pos.shape[1]).expand(S, -1)
        stacked_pos = torch.stack([t.cpu() for t in pos])
        facts["gather_equal"] = bool(torch.equal(si.shard_rows(pos, idx).cpu(),
                                                 si.shard_rows(stacked_pos, idx.cpu())))
    # each process flips a word of its first shard's BWT table; every
    # process then reads every shard's word through its own map
    bwt = al.sh.bwt_blocks
    if isinstance(bwt, peer.Shards):
        host = stacked.bwt_blocks.view(np.int32)[:, 0, 0]
        flip = 0x5A5A5A5A
        peer.barrier(layout.group)  # no process reads the tables any more
        bwt.held[0, 0, 0] ^= flip
        peer.barrier(layout.group)
        firsts = {s for s in range(S) if s % len(layout.held) == 0}
        facts["seen"] = [int(bwt[s][0, 0]) == int(host[s] ^ flip if s in firsts else host[s])
                         for s in range(S)]
        peer.barrier(layout.group)
    al.close()
    with open(f"{out}.{pid}.json", "w") as fh:
        json.dump(facts, fh)


def flagwait_main(pid, nprocs, out, device):
    import json
    import time

    import numpy as np
    import torch

    from genome_weaver_align_tpu_torch.ops import ring_cuda
    from genome_weaver_align_tpu_torch.parallel import multihost as mh
    from genome_weaver_align_tpu_torch.parallel import peer, ring

    group = mh.interval_group(nprocs)

    def flag_words():
        return peer.share(torch.zeros((nprocs, ring_cuda.WAIT_BLOCKS), dtype=torch.int32,
                                      device=device), group)

    mapped = {"flags": flag_words()}
    error = torch.zeros(1, dtype=torch.int32, device=device)
    rng = np.random.default_rng(7)  # every process draws every process's partial
    facts = {"card": device.index, "cards": list(mapped["flags"].cards), "equal": [],
             "pushed": []}
    before = ring_cuda.ring_allreduce_wait_cuda.launches
    for epoch, (dtype, n) in enumerate([(np.int32, 65_536), (np.int32, 7), (np.float32, 4099),
                                        (np.float32, 65_536)], start=1):
        x = torch.from_numpy(
            rng.integers(-(1 << 30), 1 << 30, size=(nprocs, n)).astype(np.int32)
            if dtype == np.int32 else (rng.standard_normal((nprocs, n)) * 1e4).astype(dtype))
        own = torch.zeros_like(x, device=device)
        own[pid] = x[pid].to(device)  # this process's partial: its row of its inbox
        mapped["inboxes"] = peer.share(own, group)
        got = ring_cuda.ring_allreduce_wait_cuda(mapped["inboxes"], mapped["flags"], pid, epoch,
                                                 error)
        facts["equal"].append(bool(torch.equal(got.cpu(), ring.ring_psum_plain(x)[pid])))
        facts["pushed"].append(bool(torch.equal(own.cpu(), x)))  # every peer's row arrived
        peer.release(group, lambda: mapped.pop("inboxes"))
    facts["launches"] = ring_cuda.ring_allreduce_wait_cuda.launches - before
    facts["error"] = int(error.item())
    peer.release(group, mapped.clear)

    # process 0 times out at epoch 1 and runs on; the others arrive late
    flags = flag_words()
    mapped.update(flags=flags, inboxes=peer.share(torch.ones((nprocs, 1024), dtype=torch.int32,
                                                             device=device), group))
    error = torch.zeros(1, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    if pid == 0:
        for epoch, timeout_s in ((1, 0.5), (2, 30.0), (3, 30.0)):
            ring_cuda.ring_allreduce_wait_cuda(mapped["inboxes"], flags, 0, epoch, error,
                                               timeout_s=timeout_s)
        torch.cuda.synchronize(device)
    peer.barrier(group)
    if pid != 0:
        t0 = time.perf_counter()
        ring_cuda.ring_allreduce_wait_cuda(mapped["inboxes"], flags, pid, 1, error,
                                           timeout_s=30.0)
        torch.cuda.synchronize(device)
    facts["failure_s"] = time.perf_counter() - t0
    peer.barrier(group)  # every process's failure is published
    facts["poisoned"] = [bool((row == ring_cuda.POISON).all()) for row in flags[pid].cpu()]
    try:
        ring_cuda.check_flag_wait(error)
        facts["raised"] = False
    except RuntimeError:
        facts["raised"] = True
    del flags
    peer.release(group, mapped.clear)
    with open(f"{out}.{pid}.json", "w") as fh:
        json.dump(facts, fh)


if __name__ == "__main__":
    main(sys.argv[1:])
