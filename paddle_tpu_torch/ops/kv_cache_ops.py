"""KV-cache ops of the decode engine, plain PyTorch.

Counterparts of paddle_tpu/ops/kv_cache_ops.py `kv_cache_prefill`,
`kv_cache_update`, `kv_decode_attention` and `sample_next_token` (the
contiguous cache) and of its paged variants `kv_cache_prefill_paged`,
`kv_cache_update_paged`, `kv_decode_attention_paged` and
`kv_prefix_attention`, and of the speculative verify step's
`kv_cache_update_span_paged` and `kv_verify_attention_paged`, which are
plain jnp in the JAX package: no kernel is owed for them.

The contiguous cache is one [slots, layers, heads, max_len, head_dim]
tensor per K and V; the paged cache one [num_blocks, layers, heads,
block_size, head_dim] tensor per K and V, addressed through block tables
(a slot's logical position p lives in block ``table[p // block_size]`` at
offset ``p % block_size``; table entry 0 is the trash block, which no
request owns, so a pad row, an idle slot or a clipped position only ever
writes there). Unlike the JAX ops, which return a new cache that donation
aliases onto the old buffer, the writes here update the cache **in
place**.

Every op is slot-row-independent, which is what makes admitting and
evicting requests at token boundaries safe while other slots are
mid-sequence. Positions past a slot's write head hold stale rows of earlier
tenants; :func:`kv_decode_attention` zeroes their weights after the softmax
with a select (never a multiply by a 0/1 mask), so a stale row contributes
exactly 0 whatever finite values it holds. The cache is allocated with
zeros, so it never holds uninitialised (possibly NaN) bits.
"""
import torch

__all__ = ['kv_cache_prefill', 'kv_cache_update', 'kv_decode_attention',
           'kv_cache_prefill_paged', 'kv_cache_update_paged',
           'kv_decode_attention_paged', 'kv_prefix_attention',
           'kv_cache_update_span_paged', 'kv_verify_attention_paged',
           'sample_next_token']

_NEG_INF = -1e30


def kv_cache_prefill(cache, new, slot, layer):
    """cache[slot, layer, :, 0:T, :] = new[0] for new [1, H, T, dh]; in
    place. ``slot`` is a host int or a 0-d or [1] int64 tensor on the
    cache's device (the JAX program's ``gen_slot`` feed): then the write
    reads no host value, as a CUDA graph's capture needs."""
    T = new.shape[2]
    if torch.is_tensor(slot):
        cache[:, int(layer), :, :T].index_copy_(0, slot.reshape(1), new)
    else:
        cache[int(slot), int(layer), :, :T, :] = new[0]
    return cache


def kv_cache_update(cache, new, positions, layer):
    """cache[s, layer, :, positions[s], :] = new[s] for every slot s, with
    new [S, H, dh] and positions [S] int64; in place."""
    S = cache.shape[0]
    rows = torch.arange(S, device=cache.device)
    cache[:, int(layer)][rows, :, positions, :] = new
    return cache


def kv_decode_attention(q, k_cache, v_cache, positions, layer, scale):
    """One-query attention per slot over its cached K/V, masked to cache
    positions 0..positions[s] inclusive (the step's own token was just
    written at positions[s]). q [S, H, dh] -> [S, H, dh]."""
    return _attend_cached(q, k_cache[:, int(layer)], v_cache[:, int(layer)],
                          positions, scale)


def _attend_cached(q, k, v, positions, scale):
    """One-query attention per slot: q [S, H, dh] against k, v [S, H, M,
    dh] in logical position order, slot s keeping positions
    0..positions[s]."""
    scores = torch.einsum('shd,shmd->shm', q, k) * scale
    M = k.shape[2]
    keep = torch.arange(M, device=q.device)[None, None, :] <= \
        positions[:, None, None]
    scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    w = torch.softmax(scores, dim=-1)
    # exact zero for stale rows: a select, so 0 * NaN never happens
    w = torch.where(keep, w, torch.zeros_like(w))
    return torch.einsum('shm,shmd->shd', w, v)


# ---------------------------------------------------------------------------
# paged (block-table) variants


def _block_of(table, pos, block_size):
    """(block id, in-block offset) of logical position(s) ``pos`` through a
    block table (its last dimension). Out-of-range table indices clip to
    the last entry; unallocated entries hold 0, the trash block, so a wild
    position can only ever touch trash."""
    idx = torch.clamp(pos // block_size, 0, table.shape[-1] - 1)
    return table[idx], pos % block_size


def _gather_blocks(cache, layer, tables):
    """cache[:, layer][tables] in logical position order: tables [S, MB] ->
    [S, H, MB * block_size, dh] (a copy)."""
    g = cache[:, int(layer)][tables]                # [S, MB, H, bs, dh]
    S, MB, H, bs, dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(S, H, MB * bs, dh)


def kv_cache_prefill_paged(cache, new, table, positions, length, layer,
                           block_size):
    """cache[table[p_t // bs], layer, :, p_t % bs, :] = new[0, :, t, :] for
    the suffix rows t < ``length`` (p = ``positions`` [T], the rows' global
    positions); rows at or past ``length`` (the bucket's pad rows) are
    redirected to the trash block, offset 0: a paged slot owns no span
    where pad garbage could park. new [1, H, T, dh], table [MB] int64,
    ``length`` a host int or a 0-d or [1] int64 tensor on the cache's
    device (the ``gen_len`` feed); in place."""
    rows = new[0].transpose(0, 1)                   # [T, H, dh]
    blk, off = _block_of(table, positions, int(block_size))
    if not torch.is_tensor(length):
        length = int(length)
    real = torch.arange(rows.shape[0], device=rows.device) < length
    blk = torch.where(real, blk, torch.zeros_like(blk))
    off = torch.where(real, off, torch.zeros_like(off))
    cache[:, int(layer)][blk, :, off, :] = rows
    return cache


def kv_cache_update_paged(cache, new, tables, positions, layer, block_size,
                          valid=None):
    """cache[tables[s][p_s // bs], layer, :, p_s % bs, :] = new[s] for every
    slot s (p = ``positions`` [S]). Idle slots feed position 0 against an
    all-zero table row, so their garbage row lands in the trash block. An
    optional ``valid`` ([S] or [S, 1]; nonzero = keep) redirects invalid
    rows to the trash block explicitly, for positions at or past max_len
    where the clipped table lookup would otherwise name a live block.
    new [S, H, dh], tables [S, MB] int64; in place."""
    bs = int(block_size)
    idx = torch.clamp(positions // bs, 0, tables.shape[1] - 1)
    blk = torch.gather(tables, 1, idx[:, None])[:, 0]
    off = positions % bs
    if valid is not None:
        keep = valid.reshape(-1) != 0
        blk = torch.where(keep, blk, torch.zeros_like(blk))
        off = torch.where(keep, off, torch.zeros_like(off))
    cache[:, int(layer)][blk, :, off, :] = new
    return cache


def kv_decode_attention_paged(q, k_cache, v_cache, tables, positions, layer,
                              scale):
    """One-query attention per slot over its block-table-gathered K/V
    (``cache[:, layer][tables]``, table order x in-block offset), masked
    to positions 0..positions[s] exactly as :func:`kv_decode_attention`:
    masked (stale, trash, shared-beyond-prefix) rows contribute exact 0.
    q [S, H, dh], tables [S, MB] -> [S, H, dh]."""
    return _attend_cached(q, _gather_blocks(k_cache, layer, tables),
                          _gather_blocks(v_cache, layer, tables),
                          positions, scale)


def kv_prefix_attention(q, k_cache, v_cache, table, positions, layer, scale):
    """Multi-query causal attention of one slot's prefill suffix against
    its block-table cache: query row t sits at global position
    positions[t] and attends every cached position <= positions[t] — a
    shared prefix cached by an earlier request (or an earlier chunk) plus
    the suffix rows just written. With positions starting at 0 this is the
    causal prefill attention, computed from the cache. q [1, H, T, dh],
    table [MB] -> [1, H, T, dh]."""
    k = _gather_blocks(k_cache, layer, table[None])[0]    # [H, M, dh]
    v = _gather_blocks(v_cache, layer, table[None])[0]
    scores = torch.einsum('htd,hmd->htm', q[0], k) * scale
    M = k.shape[1]
    keep = torch.arange(M, device=q.device)[None, :] <= \
        positions[:, None]                          # [T, M]
    scores = torch.where(keep[None], scores,
                         torch.full_like(scores, _NEG_INF))
    w = torch.softmax(scores, dim=-1)
    w = torch.where(keep[None], w, torch.zeros_like(w))
    return torch.einsum('htm,hmd->htd', w, v)[None]


def kv_cache_update_span_paged(cache, new, tables, positions, valid, layer,
                               block_size):
    """The verify step's wide write: every slot deposits W rows,
    cache[tables[s][p // bs], layer, :, p % bs, :] = new[s, :, t, :] with
    p = positions[s, t]. Rows with ``valid[s, t] == 0`` (idle slots,
    positions past max_len or past the slot's blocks, rows past the
    request's budget) go to the trash block at offset 0: a speculative row
    may be rolled back later, but it never touches a live block the slot
    does not own. new [S, H, W, dh], tables [S, MB], positions and valid
    [S, W] int64; in place."""
    bs = int(block_size)
    idx = torch.clamp(positions // bs, 0, tables.shape[1] - 1)
    blk = torch.gather(tables, 1, idx)                  # [S, W]
    off = positions % bs
    keep = valid != 0
    blk = torch.where(keep, blk, torch.zeros_like(blk))
    off = torch.where(keep, off, torch.zeros_like(off))
    rows = new.permute(0, 2, 1, 3).reshape(-1, new.shape[1], new.shape[3])
    cache[:, int(layer)][blk.reshape(-1), :, off.reshape(-1), :] = rows
    return cache


def kv_verify_attention_paged(q, k_cache, v_cache, tables, positions, layer,
                              scale):
    """W-query attention per slot over its block-table-gathered K/V: query
    row (s, t) sits at position positions[s, t] and attends every cached
    position <= positions[s, t], the slot's accepted history plus the
    window's rows at or before t (the span write deposited them). Each of
    the S * W rows runs through :func:`kv_decode_attention_paged`'s own
    products (one query against its slot's gathered K/V, repeated for the
    window's rows), so a row's output has the bits the one-token step
    computes at that position on the CPU: the acceptance oracle of
    speculative decoding. Masked (stale, trash, rolled-back) rows give
    exactly 0. q [S, H, W, dh], tables [S, MB], positions [S, W] ->
    [S, H, W, dh]."""
    S, H, W, dh = q.shape

    def rows(cache):
        g = _gather_blocks(cache, layer, tables)        # [S, H, M, dh]
        return g[:, None].expand(S, W, *g.shape[1:]).reshape(
            S * W, *g.shape[1:])

    out = _attend_cached(q.permute(0, 2, 1, 3).reshape(S * W, H, dh),
                         rows(k_cache), rows(v_cache),
                         positions.reshape(-1), scale)
    return out.view(S, W, H, dh).permute(0, 2, 1, 3)


def sample_next_token(logits, temp, topk, topp, u, any_sampled=None):
    """Per-row temperature / top-k / top-p sampling driven by a host-drawn
    uniform u[s] in [0, 1), as the JAX `sample_next_token` op: sort the
    temperature-scaled distribution descending (stable, so ties keep index
    order), intersect the top-k and nucleus keep sets, renormalise, and
    invert the CDF at u. Rows with temp <= 0 return the argmax (first
    index of the maximum). topk <= 0 disables top-k; topp <= 0 or >= 1
    disables nucleus. logits [S, V] f32; the controls are [S]. Returns [S]
    int64.

    ``any_sampled`` is the caller's host-side knowledge of whether any row
    has temp > 0 (None = read it from ``temp``, a device sync on a card);
    when no row samples, the sort is skipped — the result is the same
    argmax either way."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=1)
    sampled_rows = temp > 0
    if any_sampled is None:
        any_sampled = bool(sampled_rows.any())
    if not any_sampled:
        return greedy
    V = logits.shape[1]
    t = torch.where(sampled_rows, temp, torch.ones_like(temp))[:, None]
    order = torch.argsort(-logits, dim=1, stable=True)
    sorted_logits = torch.gather(logits / t, 1, order)
    probs = torch.softmax(sorted_logits, dim=1)
    ranks = torch.arange(V, device=logits.device)[None, :]
    k_eff = torch.where(topk > 0, topk, torch.full_like(topk, V))[:, None]
    p_on = (topp > 0) & (topp < 1.0)
    p_eff = torch.where(p_on, topp, torch.ones_like(topp))[:, None]
    cum = torch.cumsum(probs, dim=1)
    keep = (ranks < k_eff) & ((cum - probs < p_eff) | (ranks == 0))
    masked = torch.where(keep, probs, torch.zeros_like(probs))
    mcum = torch.cumsum(masked, dim=1)
    total = mcum[:, -1:]
    j = torch.sum(mcum <= u[:, None] * total, dim=1)
    j = torch.minimum(j, keep.sum(dim=1) - 1)
    sampled = torch.gather(order, 1, j[:, None])[:, 0]
    return torch.where(sampled_rows, sampled, greedy)
