"""Numpy models of the two verify kernels' group designs, in the kernels' own
order of operations, for the CPU tests: ``csrc/myers.cu``'s group of G
threads a lane (P words a thread, run as a wavefront: thread j a column
behind thread j - 1, the add's carry and the top bits of Ph and Mh handed
up one time step later), ``csrc/banded_group.cu``'s group of G
threads a lane (N band slots a thread padded at the band's bottom with pads
that never match, each thread's fused scan, the group's exclusive prefix min
of c_j - j, no bounds check of the window, the window codes by position) and
its scratch kernel (a warp a lane, the per-cell window check and the pads
held at 2^30, ``csrc/banded_dp.cu``). Each runs every lane of a batch at
once; the tests hold them against the plain torch versions on every lane, so
a fault in the design shows here before the card runs it. The card tests
hold the kernels themselves against the plain versions."""

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
INF = 1 << 20
BIG = 1 << 30
NO_MATCH = 256


def myers_wavefront(reads, lengths, windows, nwords: int, steps: int, G: int, P: int):
    """``myers_group_kernel`` over (Q, L) reads and (Q, W) windows (codes;
    >= 4 never match, a negative code reads Peq[0]) with G threads of P
    words a lane, run as its wavefront -> (best (Q,), end (Q,)) int32.

    At time step t thread j runs column t - j: it takes the add's carry and
    the top bits of Ph and Mh that thread j - 1 computed for that column,
    handed up at time step t - 1 (thread 0 takes 0: the free text start),
    and hands up its own.  Before its column 0 a thread runs dead columns
    (Peq = 0), which leave the initial state as it is; past the last column
    its state runs on and is never scored.  The thread that holds bit
    len - 1 keeps score, best and the end at its own column, from its Ph
    and Mh bits at len - 1 collected a time step at a time and scored every
    16 time steps (at once where the run's lowest reachable score cannot
    beat best)."""
    Q, L = reads.shape
    W = windows.shape[1]
    assert G * P >= nwords and G & (G - 1) == 0
    lengths = np.asarray(lengths, np.int64)
    n_in = np.minimum(lengths, L)
    # eq[c, q, j, u]: word v = j P + u of code c
    eq = np.zeros((4, Q, G, P), np.uint64)
    for j in range(G):
        for u in range(P):
            v = j * P + u
            if v >= nwords:
                continue
            for b in range(32):
                i = 32 * v + b
                if i >= L:
                    break
                on = i < n_in
                for c in range(4):
                    eq[c, :, j, u] |= np.where(on & (reads[:, i] == c), np.uint64(1 << b),
                                               np.uint64(0))
    pv = np.full((Q, G, P), M32, np.uint64)
    mv = np.zeros((Q, G, P), np.uint64)
    last_word = np.where(lengths >= 1, (lengths - 1) >> 5, -1)
    has_owner = (last_word >= 0) & (last_word < nwords)
    own_j = np.where(has_owner, last_word // P, 0)
    own_u = np.where(has_owner, last_word % P, -1)
    own_bit = np.where(lengths >= 1, np.uint64(1) << ((lengths - 1) & 31).astype(np.uint64),
                       np.uint64(0))
    score = lengths.copy()
    best = lengths.copy()
    end = np.zeros(Q, np.int64)
    q = np.arange(Q)
    j = np.arange(G)
    # carry, Ph top, Mh top of each thread's column of the last time step
    handed = np.zeros((Q, G, 3), np.uint64)
    n_steps = steps + G - 1 if steps > 0 else 0
    up_run = np.zeros(Q, np.int64)
    dn_run = np.zeros(Q, np.int64)
    stop = steps + own_j  # the owner's time steps past its last column

    def score_run(k, t_last):
        nonlocal score, best, end, up_run, dn_run
        live = np.clip(stop - (t_last - k + 1), 0, k)
        keep = ((1 << live) - 1) << (k - live)
        u, d = up_run & keep, dn_run & keep
        up_run, dn_run = np.zeros_like(up_run), np.zeros_like(dn_run)
        pu = np.array([bin(x).count("1") for x in u])
        pd = np.array([bin(x).count("1") for x in d])
        quick = score - pd >= best
        score = np.where(quick, score + pu - pd, score)
        for i in range(k - 1, -1, -1):
            score = np.where(quick, score, score + ((u >> i) & 1) - ((d >> i) & 1))
            better = ~quick & (score < best)
            end = np.where(better, t_last - i - own_j + 1, end)
            best = np.where(better, score, best)

    for t in range(n_steps):
        inp = np.zeros((Q, G, 3), np.uint64)
        inp[:, 1:] = handed[:, :-1]
        col = t - j  # (G,) each thread's column
        c = windows[:, np.clip(col, 0, W - 1)].astype(np.int64)  # (Q, G)
        live = (c < 4) & (col >= 0)[None, :]
        peq = np.where(live[:, :, None], eq[np.clip(c, 0, 3), q[:, None], j[None, :]],
                       np.uint64(0))  # (Q, G, P)
        carry, hp_in, hn_in = inp[:, :, 0], inp[:, :, 1], inp[:, :, 2]
        up = np.zeros((Q, G), bool)
        dn = np.zeros((Q, G), bool)
        for u in range(P):
            tot = (peq[:, :, u] & pv[:, :, u]) + pv[:, :, u] + carry
            carry = tot >> np.uint64(32)
            d0 = ((tot & M32) ^ pv[:, :, u]) | peq[:, :, u] | mv[:, :, u]
            hn = pv[:, :, u] & d0
            hp = (mv[:, :, u] | ~(pv[:, :, u] | d0)) & M32
            m = np.where(own_u == u, own_bit, np.uint64(0))[:, None]
            up |= (hp & m) != 0
            dn |= (hn & m) != 0
            xs = ((hp << np.uint64(1)) & M32) | hp_in
            hp_in = hp >> np.uint64(31)
            hns = ((hn << np.uint64(1)) & M32) | hn_in
            hn_in = hn >> np.uint64(31)
            mv[:, :, u] = xs & d0
            pv[:, :, u] = (hns | ~(xs | d0)) & M32
        handed = np.stack([carry, hp_in, hn_in], axis=-1)
        # a bit a time step, scored every 16
        up_run = (up_run << 1) | up[q, own_j]
        dn_run = (dn_run << 1) | dn[q, own_j]
        if (t + 1) % 16 == 0 or t == n_steps - 1:
            score_run(t % 16 + 1, t)
    return best.astype(np.int32), end.astype(np.int32)


def banded_group(reads, lengths, windows, k: int, G: int, N: int, beyond: int | None = None):
    """``banded_group_kernel`` over (Q, L) int8 reads and (Q, W) windows
    (bytes >= 4 never match) with G threads of N band slots a lane ->
    (dist (Q,), end_b (Q,)) int32.  Every group runs its own rows.  Off
    the window a cell reads code 256 (the windows entry), or with
    ``beyond`` (a seed) codes 0..3 made from the lane and the position, as
    the text entry reads the text around its window."""
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    assert G * N >= band
    lengths = np.asarray(lengths, np.int64)
    steps = np.minimum(lengths, L)
    b = np.arange(G * N).reshape(G, N) - (G * N - band)  # band slot of each register
    pm = (b < 0).astype(np.int64)  # pads never match
    # codes as unsigned bytes: a byte >= 4 (and off the window) is 256
    wb = np.where(windows < 4, windows.astype(np.int64) & 0xFF, NO_MATCH)
    rb = reads.astype(np.int64) & 0xFF

    lane = np.arange(Q)[:, None, None]

    def code_at(pos):  # (Q, G, N) window positions -> codes
        ok = (pos >= 0) & (pos < W)
        off = NO_MATCH if beyond is None else (lane * 7919 + pos * 104729 + beyond) % 4
        return np.where(ok, wb[lane, np.clip(pos, 0, W - 1)], off)

    D = np.where(b < 0, BIG, np.where(b >= k, 0, INF))[None].repeat(Q, 0).astype(np.int64)
    for i in range(int(steps.max(initial=0)) if W > 0 else 0):
        active = i < steps
        wc = code_at(np.broadcast_to(i + b - k, (Q, G, N)))  # the rotated registers' codes
        rc = rb[:, min(i, L - 1)]
        above = np.full((Q, G), INF, np.int64)
        above[:, :-1] = D[:, 1:, 0]  # the next thread's slot 0, row i - 1
        up = np.concatenate([D[:, :, 1:], above[:, :, None]], axis=2)
        x = (wc ^ rc[:, None, None]) | pm[None]
        new = np.empty_like(D)
        new[:, :, 0] = np.minimum(np.minimum(D[:, :, 0], up[:, :, 0]) + 1, D[:, :, 0] + x[:, :, 0])
        for s in range(1, N):
            m = np.minimum(np.minimum(new[:, :, s - 1], D[:, :, s]), up[:, :, s])
            new[:, :, s] = np.minimum(m + 1, D[:, :, s] + x[:, :, s])
        v = new[:, :, N - 1] - b[None, :, N - 1]
        incl = np.minimum.accumulate(v, axis=1)
        cin = np.full((Q, G), BIG, np.int64)
        cin[:, 1:] = incl[:, :-1]
        new = np.minimum(new, cin[:, :, None] + b[None])
        if i == 0:  # row 0's slots below the diagonal: INF (the row before is 0 from slot k)
            new = np.where(((b >= 0) & (b < k))[None], INF, new)
        D = np.where(active[:, None, None], new, D)
    if W == 0:
        D = np.where((steps > 0)[:, None, None], INF, D)
    j_end = lengths[:, None, None] + b[None] - k
    df = np.where((j_end >= 0) & (j_end <= W), np.minimum(D, INF), INF)
    df = np.where(b[None] >= 0, df, BIG).reshape(Q, G * N)
    best_at = df.argmin(axis=1)
    dist = np.minimum(df[np.arange(Q), best_at], INF)
    return dist.astype(np.int32), b.reshape(-1)[best_at].astype(np.int32)


def banded_scratch(reads, lengths, windows, k: int, G: int, S: int):
    """``banded_mem_kernel`` over (Q, L) int8 reads and (Q, W) windows
    (bytes >= 4 never match) with G threads of S band slots a lane ->
    (dist (Q,), end_b (Q,)) int32."""
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    assert G * S >= band
    lengths = np.asarray(lengths, np.int64)
    steps = np.minimum(lengths, L)
    b = np.arange(G * S).reshape(G, S) - (G * S - band)  # band slot of each register
    wb = np.where(windows < 4, windows.astype(np.int64), NO_MATCH)

    def code_at(jp):  # (Q,) window positions -> codes
        ok = (jp >= 0) & (jp < W)
        return np.where(ok, wb[np.arange(Q), np.clip(jp, 0, W - 1)], NO_MATCH)

    D = np.where(b < 0, BIG, np.where(b >= k, 0, INF))[None].repeat(Q, 0).astype(np.int64)
    wc = np.full((Q, G, S), NO_MATCH, np.int64)
    for j in range(G):
        for s in range(S):
            if k <= b[j, s] < band - 1:
                wc[:, j, s] = code_at(np.full(Q, b[j, s] - k))
    for i in range(int(steps.max(initial=0))):
        active = i < steps
        wc[:, G - 1, S - 1] = code_at(np.full(Q, i + 3 * k))
        rc = np.where(active, reads[:, min(i, L - 1)].astype(np.int64), 0)
        above = np.full((Q, G), INF, np.int64)
        above[:, :-1] = D[:, 1:, 0]
        up = np.concatenate([D[:, :, 1:], above[:, :, None]], axis=2)
        valid = ((i + b - k) >= 0) & ((i + b - k) < W)
        x = (wc ^ rc[:, None, None]) & 0x1FF
        t = np.where(valid[None], np.minimum(np.minimum(D, up) + 1, D + x), INF)
        t = np.where(b[None] < 0, BIG, t)
        l = np.empty_like(t)
        run = t[:, :, 0]
        l[:, :, 0] = run
        for s in range(1, S):
            run = np.minimum(run + 1, t[:, :, s])
            l[:, :, s] = run
        o = run - b[None, :, S - 1]
        incl = np.minimum.accumulate(o, axis=1)
        cin = np.full((Q, G), BIG, np.int64)
        cin[:, 1:] = incl[:, :-1]
        nd = np.minimum(l, cin[:, :, None] + b[None])
        D = np.where(active[:, None, None], nd, D)
        w0 = np.full((Q, G), NO_MATCH, np.int64)
        w0[:, :-1] = wc[:, 1:, 0]
        w0[:, -1] = wc[:, -1, 0]
        wc = np.concatenate([wc[:, :, 1:], w0[:, :, None]], axis=2)
    j_end = lengths[:, None, None] + b[None] - k
    df = np.where((j_end >= 0) & (j_end <= W), D, INF)
    df = np.where(b[None] >= 0, df, BIG).reshape(Q, G * S)
    best_at = df.argmin(axis=1)
    dist = np.minimum(df[np.arange(Q), best_at], INF)
    return dist.astype(np.int32), b.reshape(-1)[best_at].astype(np.int32)
