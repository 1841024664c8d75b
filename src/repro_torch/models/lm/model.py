"""LM model assembly: init / train forward / loss / prefill / decode per
family.

Counterpart of `repro/models/lm/model.py`. Head = embedding (+ modality
frontend stub), Body = the repeated block run over stacked layer
parameters, Tail = final norm, Classifier = the LM head. Stacked layer
parameters and caches keep the JAX trees' leading `[L, ...]` axis, so a
JAX tree converts one to one; the JAX model's `lax.scan` over that axis is
a Python loop here. On the training path each (super-)block of that loop,
and each encoder and decoder layer of the enc-dec archs, runs under
`_remat` (`cfg.remat`): activation checkpointing, which changes memory,
never numbers. `prefill` and `decode_step` update the caches in place,
each layer in its slot of the stacked tensors, and return them: a decode
step writes one position of the KV cache, not a copy of it.

Every init returns (params, logical), logical mirroring params with tuples
of logical axis names; stacked layer params get a leading `None`.

Entry points that make tensors (`init_params`, `init_cache`) run on CUDA
unless the caller names a device; the forward functions and `loss_fn` run
where their inputs lie. On parameters placed on a mesh of several
devices, `loss_fn`, `forward_train`, `prefill` and `decode_step` of every
family run partitioned (tensor parallelism, expert parallelism, FSDP,
data parallelism: the last section).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.core.cu import resolve_device
from repro_torch.models.lm import common as C
from repro_torch.models.lm import mamba2 as M2
from repro_torch.models.lm import moe as MOE
from repro_torch.models.lm import rglru as RG
from repro_torch.models.lm.config import LMConfig

F32 = torch.float32


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree, i: int):
    return tree_map(lambda t: t[i], tree)


def _stack(trees):
    """[tree] -> one tree with each leaf stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _write(dst, src):
    """Copy a layer's new cache into `dst`, its slot of the caches; a leaf
    that the layer wrote in place (a KV cache) is that slot already."""
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# per-family single-layer init/apply
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: LMConfig, kind: str):
    """kind: dense | moe | rec | attn_local | ssm | enc | dec."""
    p, lg = {}, {}
    if kind == "ssm":
        p["ln1"], lg["ln1"] = C.init_norm(gen, cfg.d_model, cfg)
        p["mix"], lg["mix"] = M2.init_mamba2_block(gen, cfg)
        return p, lg
    p["ln1"], lg["ln1"] = C.init_norm(gen, cfg.d_model, cfg)
    if kind == "rec":
        p["mix"], lg["mix"] = RG.init_rglru_block(gen, cfg)
    else:
        p["mix"], lg["mix"] = C.init_attention(gen, cfg)
    p["ln2"], lg["ln2"] = C.init_norm(gen, cfg.d_model, cfg)
    if kind == "moe":
        p["ffn"], lg["ffn"] = MOE.init_moe(gen, cfg)
    else:
        p["ffn"], lg["ffn"] = C.init_mlp(gen, cfg)
    if kind == "dec":  # cross-attention sublayer
        p["ln_x"], lg["ln_x"] = C.init_norm(gen, cfg.d_model, cfg)
        p["xattn"], lg["xattn"] = C.init_attention(gen, cfg)
    return p, lg


def _apply_layer(p, x, cfg: LMConfig, kind: str, positions, *,
                 cache=None, cache_pos=None, memory=None):
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = C.rms_norm(x, p["ln1"], cfg.norm_eps)
    new_cache = cache
    if kind == "ssm":
        out, new_cache = M2.mamba2_block(p["mix"], h, cfg, state=cache)
        if cache is None:  # no state carried
            new_cache = None
        return x + out, new_cache, aux
    if kind == "rec":
        out, new_cache = RG.rglru_block(p["mix"], h, cfg, state=cache)
        if cache is None:
            new_cache = None
    else:
        window = cfg.local_window if kind == "attn_local" else 0
        self_cache = (cache.get("self") if isinstance(cache, dict)
                      and "self" in cache else cache)
        out, new_cache = C.attention_block(
            p["mix"], h, cfg, positions, causal=kind != "enc", window=window,
            kv_cache=self_cache, cache_pos=cache_pos)
    x = x + out
    if kind == "dec" and memory is not None:
        hx = C.rms_norm(x, p["ln_x"], cfg.norm_eps)
        if isinstance(cache, dict) and "cross" in cache:
            # cross K/V are precomputed at prefill; reuse
            xout = _cross_from_cache(p["xattn"], hx, cfg, cache["cross"])
            new_cache = {"self": new_cache, "cross": cache["cross"]}
        else:
            xout, _ = C.attention_block(p["xattn"], hx, cfg, positions,
                                        causal=False, xk=memory)
            if cache is not None:
                new_cache = {"self": new_cache,
                             "cross": _make_cross_cache(p["xattn"], cfg,
                                                        memory)}
        x = x + xout
    hf = C.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        out, aux = MOE.moe_ffn(p["ffn"], hf, cfg)
    else:
        out = C.mlp(p["ffn"], hf)
    return x + out, new_cache, aux


def _make_cross_cache(p_attn, cfg, memory):
    hd = cfg.head_dim
    k = C.linear(memory, p_attn["wk"]).reshape(*memory.shape[:-1],
                                               cfg.n_kv_heads, hd)
    v = C.linear(memory, p_attn["wv"]).reshape(*memory.shape[:-1],
                                               cfg.n_kv_heads, hd)
    return {"k": k, "v": v}


def _cross_from_cache(p_attn, x, cfg, cross):
    hd = cfg.head_dim
    q = C.linear(x, p_attn["wq"]).reshape(*x.shape[:-1], cfg.n_heads, hd)
    if cfg.qk_norm:
        q = C.rms_norm(q, p_attn["qnorm"], cfg.norm_eps)
    out = C.full_attention(q, cross["k"], cross["v"], causal=False)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * hd)
    return C.linear(out, p_attn["wo"])


# ---------------------------------------------------------------------------
# layer-kind schedule per family
# ---------------------------------------------------------------------------


def layer_kinds(cfg: LMConfig) -> Tuple[str, ...]:
    if cfg.family == "moe":
        return tuple("moe" for _ in range(cfg.n_layers))
    if cfg.family == "ssm":
        return tuple("ssm" for _ in range(cfg.n_layers))
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("attn",)
        return tuple(
            ("attn_local" if pat[i % len(pat)] == "attn" else "rec")
            for i in range(cfg.n_layers))
    return tuple("dense" for _ in range(cfg.n_layers))


def _kind_groups(kinds: Tuple[str, ...]):
    """Group layers into a repeating super-block (stacked) + a tail."""
    if len(set(kinds)) == 1:
        return (kinds[0],), len(kinds), ()
    pat = _pattern_period(kinds)
    n_super = len(kinds) // len(pat)
    tail = kinds[n_super * len(pat):]
    return pat, n_super, tail


def _pattern_period(kinds):
    """Smallest prefix that tiles the whole layer-kind sequence."""
    for plen in range(1, len(kinds) + 1):
        if all(kinds[i] == kinds[i % plen] for i in range(len(kinds))):
            return kinds[:plen]
    return kinds


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------


def padded_vocab(cfg: LMConfig) -> int:
    """Vocab padded to a multiple of 512. The published vocab size is kept
    for sampling: pad logits are masked to -1e30 in `logits_from_hidden`."""
    return -(-cfg.vocab // 512) * 512


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _logical_map(fn, lg):
    if _is_axes(lg):
        return fn(lg)
    return {k: _logical_map(fn, v) for k, v in lg.items()}


def init_params(cfg: LMConfig, seed: int = 0,
                device=None) -> Tuple[Dict, Dict]:
    """(params, logical) of `cfg`, drawn on `device` (CUDA unless named)
    from a generator seeded with `seed`. The same shapes, types and
    distributions as the JAX model's `init_params`, not its draws. On
    `device="meta"` the tensors have shapes and types alone (the
    reference's `jax.eval_shape` of its init)."""
    dev = resolve_device(device)
    gen = (C.MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    p: Dict[str, Any] = {}
    lg: Dict[str, Any] = {}
    vp = padded_vocab(cfg)
    p["embed"] = C.normal(gen, (vp, cfg.d_model),
                          cfg.d_model**-0.5).to(C.dt(cfg))
    lg["embed"] = ("vocab", "embed")
    if not cfg.tie_embeddings:
        p["lm_head"], lg["lm_head"] = C.init_linear(
            gen, cfg.d_model, vp, "embed", "vocab", cfg)
    p["ln_f"], lg["ln_f"] = C.init_norm(gen, cfg.d_model, cfg)

    def stack(kind, n):
        layers = [_init_layer(gen, cfg, kind) for _ in range(max(n, 1))]
        return (_stack([q for q, _ in layers]),
                _logical_map(lambda ax: (None, *ax), layers[0][1]))

    if cfg.family in ("encdec", "audio"):
        p["enc"], lg["enc"] = stack("enc", cfg.n_enc_layers)
        p["dec"], lg["dec"] = stack("dec", cfg.n_dec_layers)
        p["ln_enc"], lg["ln_enc"] = C.init_norm(gen, cfg.d_model, cfg)
    else:
        pat, n_super, tail = _kind_groups(layer_kinds(cfg))
        if len(pat) == 1:
            p["layers"], lg["layers"] = stack(pat[0], n_super)
        else:
            sup_p, sup_lg = {}, {}
            for i, kind in enumerate(pat):
                sup_p[f"l{i}"], sup_lg[f"l{i}"] = stack(kind, n_super)
            p["layers"], lg["layers"] = sup_p, sup_lg
        for i, kind in enumerate(tail):
            p[f"tail{i}"], lg[f"tail{i}"] = _init_layer(gen, cfg, kind)
        if cfg.frontend:
            # modality frontend STUB: one projection from precomputed
            # patch/frame embeddings into d_model
            p["frontend_proj"], lg["frontend_proj"] = C.init_linear(
                gen, cfg.d_model, cfg.d_model, None, "embed", cfg)
    return p, lg


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """`checkpoint_dots_with_no_batch_dims`: keep the products without a
    batch axis (the linears, `aten.mm`/`addmm`), recompute the rest (the
    attention and expert einsums, which reach `aten.bmm`, included)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: LMConfig):
    """`fn` under activation checkpointing as `cfg.remat` asks: "full"
    keeps only its inputs and recomputes the body in the backward pass,
    "dots" also keeps its matmul outputs (`_save_dots`), "none" keeps
    every activation. Without autograd recording the body runs as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none, full or dots: {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _run_stack(params, x, cfg, positions, *, caches=None, cache_pos=None):
    """Run the (super-)block stack. caches: tree aligned with the layers,
    updated in place, or None (training: each super-block under
    `_remat`). Returns (x, caches, aux_sum)."""
    pat, n_super, tail = _kind_groups(layer_kinds(cfg))

    def super_block(layer_p, x, aux, layer_c):
        if len(pat) == 1:
            x, new_c, a = _apply_layer(layer_p, x, cfg, pat[0], positions,
                                       cache=layer_c, cache_pos=cache_pos)
            return x, aux + a, new_c
        new_c = {}
        for i, kind in enumerate(pat):
            ci = layer_c[f"l{i}"] if layer_c is not None else None
            x, new_c[f"l{i}"], a = _apply_layer(
                layer_p[f"l{i}"], x, cfg, kind, positions, cache=ci,
                cache_pos=cache_pos)
            aux = aux + a
        return x, aux, new_c

    body = super_block if caches is not None else _remat(super_block, cfg)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for j in range(n_super):
        layer_p = _index(params["layers"], j)
        layer_c = _index(caches["layers"], j) if caches is not None else None
        x, aux, new_c = body(layer_p, x, aux, layer_c)
        if caches is not None:
            _write(layer_c, new_c)
    for i, kind in enumerate(tail):
        ci = caches[f"tail{i}"] if caches is not None else None
        x, nc, a = _apply_layer(params[f"tail{i}"], x, cfg, kind, positions,
                                cache=ci, cache_pos=cache_pos)
        aux = aux + a
        if caches is not None:
            _write(ci, nc)
    return x, caches, aux


def embed_tokens(params, cfg: LMConfig, tokens, embeds=None):
    x = params["embed"][tokens].to(C.dt(cfg))
    if cfg.family in ("vlm",) and embeds is not None:
        fe = C.linear(embeds.to(C.dt(cfg)), params["frontend_proj"])
        x = torch.cat([fe, x], dim=1)
    return x


def logits_from_hidden(params, cfg: LMConfig, x):
    x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        logits = C.linear(x, params["lm_head"])
    vp = padded_vocab(cfg)
    if vp != cfg.vocab:  # mask the padding rows out of the softmax
        mask = torch.arange(vp, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, torch.full(
            (), C.NEG, dtype=logits.dtype, device=x.device))
    return logits


def forward_train(params, cfg: LMConfig, tokens, embeds=None,
                  enc_inputs=None):
    """Causal LM (or enc-dec) forward. Returns (logits [B, S, V], aux).
    On placed parameters (a mesh of several devices) it runs partitioned
    and the logits come back placed (`_forward_spmd`)."""
    sp = _spmd_of(params)
    if sp is not None:
        return _forward_spmd(sp, params, cfg, tokens, embeds, enc_inputs)
    if cfg.family in ("encdec", "audio"):
        return _encdec_forward(params, cfg, tokens, enc_inputs)
    x = embed_tokens(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_stack(params, x, cfg, positions)
    return logits_from_hidden(params, cfg, x), aux


def _encode(params, cfg: LMConfig, enc_inputs):
    """The encoder stack over precomputed frames -> normed memory."""
    _need_frames(cfg, enc_inputs)
    enc_x = enc_inputs.to(C.dt(cfg))  # [B, S_enc, D]
    positions = torch.arange(enc_x.shape[1], device=enc_x.device)

    def enc_layer(layer_p, x):
        return _apply_layer(layer_p, x, cfg, "enc", positions)[0]

    enc_layer = _remat(enc_layer, cfg)
    for j in range(cfg.n_enc_layers):
        enc_x = enc_layer(_index(params["enc"], j), enc_x)
    return C.rms_norm(enc_x, params["ln_enc"], cfg.norm_eps)


def _need_frames(cfg: LMConfig, enc_inputs) -> None:
    if enc_inputs is None:
        raise ValueError(f"{cfg.name} ({cfg.family}): the encoder needs "
                         f"its frames, batch['enc_inputs']")


def _encdec_forward(params, cfg: LMConfig, tokens, enc_inputs):
    memory = _encode(params, cfg, enc_inputs)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)

    def dec_layer(layer_p, x):
        return _apply_layer(layer_p, x, cfg, "dec", positions,
                            memory=memory)[0]

    dec_layer = _remat(dec_layer, cfg)
    for j in range(cfg.n_dec_layers):
        x = dec_layer(_index(params["dec"], j), x)
    return (logits_from_hidden(params, cfg, x),
            torch.zeros((), dtype=F32, device=x.device))


def loss_fn(params, cfg: LMConfig, batch):
    """Next-token cross-entropy plus 0.01 x the MoE load-balancing loss.
    batch: dict(tokens [B, S] integer [, embeds, enc_inputs]).

    The JAX loss contracts the log-probabilities with a one-hot of the
    targets (to keep its vocab axis sharded); a gather of the target's
    log-probability is the same number, since every other term of that
    sum is an exact zero, and it saves a [B, S, V] float32 tensor.

    On placed parameters the loss runs partitioned (`_loss_spmd`) and
    comes back as a placed scalar, replicated."""
    sp = _spmd_of(params)
    if sp is not None:
        return _loss_spmd(sp, params, cfg, batch)
    tokens = batch["tokens"]
    logits, aux = forward_train(
        params, cfg, tokens,
        embeds=batch.get("embeds"), enc_inputs=batch.get("enc_inputs"))
    # predict tokens[:, 1:] from logits[:, :-1] (vlm: the last S positions)
    if cfg.family == "vlm" and batch.get("embeds") is not None:
        logits = logits[:, -tokens.shape[1]:]
    lp = torch.log_softmax(logits[:, :-1].to(F32), dim=-1)
    tgt = tokens[:, 1:].long()
    ll = torch.gather(lp, -1, tgt[..., None])[..., 0]
    return -ll.mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# caches: init / prefill / decode
# ---------------------------------------------------------------------------


def _layer_cache(cfg: LMConfig, kind: str, batch: int, max_len: int, dev):
    hd, kvh = cfg.head_dim or 0, cfg.n_kv_heads
    dtype = C.dt(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if kind == "ssm":
        d_in, nh, hp, ns = M2.dims(cfg)
        return {"conv": zeros((batch, cfg.conv_width - 1, d_in + 2 * ns)),
                "ssd": zeros((batch, nh, ns, hp), F32)}
    if kind == "rec":
        return {"conv": zeros((batch, cfg.conv_width - 1, cfg.lru_width)),
                "h": zeros((batch, cfg.lru_width), F32)}
    kv_dtype = torch.int8 if cfg.kv_bits == 8 else dtype
    size = min(max_len, cfg.local_window) if kind == "attn_local" \
        else max_len
    cache = {"k": zeros((batch, size, kvh, hd), kv_dtype),
             "v": zeros((batch, size, kvh, hd), kv_dtype)}
    if kind == "attn_local":
        cache["pos"] = torch.full((size,), -1, dtype=torch.int32, device=dev)
    if cfg.kv_bits == 8:
        cache["k_scale"] = zeros((batch, size, kvh), torch.bfloat16)
        cache["v_scale"] = zeros((batch, size, kvh), torch.bfloat16)
    if kind == "dec":
        return {"self": cache, "cross": None}  # cross filled at prefill
    return cache


def init_cache(cfg: LMConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None):
    """Empty caches of every layer, on `device` (CUDA unless named)."""
    dev = resolve_device(device)
    if cfg.family in ("encdec", "audio"):
        dtype = C.dt(cfg)
        hd, kvh, n = cfg.head_dim, cfg.n_kv_heads, cfg.n_dec_layers

        def zeros(s):
            return torch.zeros((n, batch, s, kvh, hd), dtype=dtype,
                               device=dev)

        return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
                "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}
    pat, n_super, tail = _kind_groups(layer_kinds(cfg))

    def stacked(kind):
        return tree_map(
            lambda t: t.expand(n_super, *t.shape).clone(),
            _layer_cache(cfg, kind, batch, max_len, dev))

    if len(pat) == 1:
        caches = {"layers": stacked(pat[0])}
    else:
        caches = {"layers": {f"l{i}": stacked(kind)
                             for i, kind in enumerate(pat)}}
    for i, kind in enumerate(tail):
        caches[f"tail{i}"] = _layer_cache(cfg, kind, batch, max_len, dev)
    return caches


def cache_logical(cfg: LMConfig):
    """Logical axes for cache leaves (batch-sharded, heads model-sharded)."""
    def leaf_axes(x):
        if x.ndim >= 4:  # [(L,)? B, S, KV, hd] or ssd [(L,)? B, H, N, P]
            lead = (None,) * (x.ndim - 4)
            return (*lead, "batch", None, "heads", None)
        if x.ndim >= 2:
            return ("batch",) + (None,) * (x.ndim - 1)
        return (None,) * x.ndim
    return leaf_axes


def prefill(params, cfg: LMConfig, tokens, max_len: int, embeds=None,
            enc_inputs=None):
    """Run the prompt, fill caches. Returns (last_logits, cache). On placed
    parameters both come back placed (`_prefill_spmd`)."""
    sp = _spmd_of(params)
    if sp is not None:
        return _prefill_spmd(sp, params, cfg, tokens, max_len, embeds,
                             enc_inputs)
    if cfg.family in ("encdec", "audio"):
        return _encdec_prefill(params, cfg, tokens, max_len, enc_inputs)
    caches = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches, _ = _run_stack(params, x, cfg, positions, caches=caches)
    return logits_from_hidden(params, cfg, x[:, -1:]), new_caches


def decode_step(params, cfg: LMConfig, token, caches, pos: int):
    """token: [B, 1] integer; pos: the current absolute position. On placed
    parameters the token, the caches and the logits are placed
    (`_decode_spmd`)."""
    pos = int(pos)
    sp = _spmd_of(params)
    if sp is not None:
        return _decode_spmd(sp, params, cfg, token, caches, pos)
    if cfg.family in ("encdec", "audio"):
        return _encdec_decode(params, cfg, token, caches, pos)
    x = embed_tokens(params, cfg, token)
    positions = pos + torch.arange(1, device=x.device)
    x, new_caches, _ = _run_stack(params, x, cfg, positions, caches=caches,
                                  cache_pos=pos)
    return logits_from_hidden(params, cfg, x), new_caches


def _dec_layer(lp, x, cfg, positions, self_c, cross_c, cache_pos):
    """One decoder layer against its self cache (written in place) and
    precomputed cross K/V."""
    hh = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = C.attention_block(lp["mix"], hh, cfg, positions, causal=True,
                               kv_cache=self_c, cache_pos=cache_pos)
    x = x + out
    hx = C.rms_norm(x, lp["ln_x"], cfg.norm_eps)
    x = x + _cross_from_cache(lp["xattn"], hx, cfg, cross_c)
    return x + C.mlp(lp["ffn"], C.rms_norm(x, lp["ln2"], cfg.norm_eps))


def _encdec_prefill(params, cfg, tokens, max_len, enc_inputs):
    memory = _encode(params, cfg, enc_inputs)
    b, s_enc = memory.shape[0], memory.shape[1]
    caches = init_cache(cfg, b, max_len, enc_len=s_enc, device=memory.device)
    hd, kvh = cfg.head_dim, cfg.n_kv_heads
    cross = []
    for j in range(cfg.n_dec_layers):
        xa = _index(params["dec"]["xattn"], j)
        cross.append({
            "k": C.linear(memory, xa["wk"]).reshape(b, s_enc, kvh, hd),
            "v": C.linear(memory, xa["wv"]).reshape(b, s_enc, kvh, hd)})
    cross = _stack(cross)

    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for j in range(cfg.n_dec_layers):
        x = _dec_layer(_index(params["dec"], j), x, cfg, positions,
                       _index(caches["self"], j), _index(cross, j), None)
    caches["cross"] = cross
    return logits_from_hidden(params, cfg, x[:, -1:]), caches


def _encdec_decode(params, cfg, token, caches, pos: int):
    x = embed_tokens(params, cfg, token)
    positions = pos + torch.arange(1, device=x.device)
    for j in range(cfg.n_dec_layers):
        x = _dec_layer(_index(params["dec"], j), x, cfg, positions,
                       _index(caches["self"], j), _index(caches["cross"], j),
                       pos)
    return logits_from_hidden(params, cfg, x), caches


# ---------------------------------------------------------------------------
# the LM partitioned over a mesh (explicit SPMD)
# ---------------------------------------------------------------------------
#
# Placed parameters (`dist.sharding.place` of `tree_shardings(logical,
# mesh, fsdp=)`: `Sharded` leaves, a mesh of several devices) run the
# partitioned program: every device runs the same ops on its own blocks in
# mesh order, joined by the collectives of `dist/sharding.py`. The layout
# is the one GSPMD makes of the reference's annotations: the batch rows
# over ('pod', 'data'), or replicated where they do not divide them;
# attention and MLP as in `common.Spmd`, Mamba-2 heads and the RG-LRU
# width over 'model' (`mamba2_spmd`, `rglru_spmd`); the vocab over
# 'model' for the embedding lookup (each device looks up the tokens its
# rows hold, zeros elsewhere, psummed), the head and the loss, whose
# log-softmax takes the max and the sum of exponentials over 'model'
# (`model.py:287-305`, `:356-364` of the reference); the vlm's image
# embeds projected (`frontend_proj`, replicated over 'model') and
# prepended; the audio family's encoder memory replicated over 'model'
# and its cross K/V cached per device's heads; caches split by batch and,
# where they divide, KV heads, SSD heads or channels (`cache_shardings`);
# the moe family's experts over 'model' where they divide it, routed on
# the global batch: capacity, token order and the aux loss over every
# row (`moe.moe_spmd`), its aux loss carried through the stack into the
# loss as the mesh-less `loss_fn` adds it.


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _spmd_of(params):
    """The partitioned program's context where `params` are placed on a
    mesh of several devices; None on the device path."""
    from repro_torch.dist.sharding import Sharded

    leaf = _first_leaf(params)
    if not isinstance(leaf, Sharded):
        return None
    return C.Spmd(leaf.mesh)


def _row_parts(sp, x, name: str) -> list:
    """The blocks of a batch input, whose rows split over every data axis
    of more than one device where the batch divides them, and over
    nothing else: `dryrun.batch_shardings`' layout. Rows that do not
    divide are replicated, and `sp.rows_split` says so."""
    from repro_torch.dist.sharding import Sharded, spec_axes

    if not isinstance(x, Sharded) or x.mesh != sp.mesh:
        raise ValueError(f"{name}: place it on the parameters' mesh "
                         f"(dryrun.batch_shardings)")
    sizes = dict(sp.mesh.shape)
    want = {a for a in sp.data_axes if sizes[a] > 1}
    split = not want or x.shape[0] % math.prod(sizes[a] for a in want) == 0
    spec = x.sharding.spec
    first = {a for a in spec_axes(spec[:1]) if sizes[a] > 1}
    if first != (want if split else set()) or spec_axes(spec[1:]):
        raise ValueError(f"{name}: rows must split over "
                         f"{sorted(want) if split else []}, not {spec!r}")
    sp.rows_split = split
    return list(x.parts)


def _placed(sp, parts, axes, shape):
    """Per-device blocks as a placed value of global `shape`, laid out by
    the logical `axes`."""
    from repro_torch.dist import sharding as S

    spec = S._fit_spec_to_shape(S.logical_to_spec(axes, sp.mesh),
                                tuple(shape), sp.mesh)
    return S.Sharded(parts, S.NamedSharding(sp.mesh, spec))


def _layer_slice(tree, j: int):
    """Layer `j` of stacked placed parameters (the leading axis is never
    split)."""
    from repro_torch.dist import sharding as S

    if isinstance(tree, dict):
        return {k: _layer_slice(v, j) for k, v in tree.items()}
    return S.Sharded([t[j] for t in tree.parts],
                     S.NamedSharding(tree.mesh, S.P(*tree.sharding.spec[1:])))


def _cache_blocks(sp, tree, j=None) -> list:
    """Each device's blocks of a placed cache tree (layer `j`'s slot of
    stacked ones)."""
    def one(k):
        return tree_map(lambda c: c.parts[k] if j is None else c.parts[k][j],
                        tree)
    return [one(k) for k in range(sp.n)]


def _embed_spmd(sp, params, cfg: LMConfig, toks, embeds=None) -> list:
    """Vocab-parallel lookup: each device its own rows of the table; the
    vlm's image embeds projected (`frontend_proj`, whole over 'model')
    and prepended."""
    tables = [p["embed"] for p in sp.local({"embed": params["embed"]})]
    vloc = tables[0].shape[0]

    def one(table, tok, rank):
        idx = tok.long() - rank * vloc
        ok = (idx >= 0) & (idx < vloc)
        rows = table[idx.clamp(0, vloc - 1)]
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        return torch.where(ok[..., None], rows, zero).to(C.dt(cfg))

    xs = sp.psum_model(sp.map(one, tables, toks, sp.rank))
    if cfg.family == "vlm" and embeds is not None:
        w = sp.local({"fp": params["frontend_proj"]})
        xs = sp.map(lambda e, p, x: torch.cat(
            [C.linear(e.to(C.dt(cfg)), p["fp"]), x], dim=1), embeds, w, xs)
    return xs


def _logits_spmd(sp, params, cfg: LMConfig, xs) -> list:
    """Each device's vocab block of the logits, pad columns masked."""
    keys = ("ln_f", "embed" if cfg.tie_embeddings else "lm_head")
    top = sp.local({k: params[k] for k in keys})
    hs = sp.map(lambda x, p: C.rms_norm(x, p["ln_f"], cfg.norm_eps), xs,
                top)
    hs = sp.column_in(hs)

    def one(h, p, rank):
        if cfg.tie_embeddings:
            logits = h @ p["embed"].to(h.dtype).T
        else:
            logits = C.linear(h, p["lm_head"])
        vloc = logits.shape[-1]
        if padded_vocab(cfg) != cfg.vocab:
            col = rank * vloc + torch.arange(vloc, device=h.device)
            logits = torch.where(col < cfg.vocab, logits, torch.full(
                (), C.NEG, dtype=logits.dtype, device=h.device))
        return logits

    return sp.map(one, hs, top, sp.rank)


def _norm(sp, xs, ps, key: str, cfg: LMConfig) -> list:
    return sp.map(lambda x, p: C.rms_norm(x, p[key], cfg.norm_eps), xs, ps)


def _layer_spmd(sp, layer_p, xs, cfg: LMConfig, kind: str, positions, *,
                caches=None, cache_pos=None, memory=None):
    """`_apply_layer` partitioned: `layer_p` the layer's placed weights,
    `caches` each device's blocks of its cache slot (written in place) or
    None; a decoder layer attends to the encoder's `memory` (training) or
    to the cross K/V its cache holds. Returns (each device's output, each
    device's aux loss: a moe layer's, else None)."""
    ps = sp.local(layer_p)
    hs = _norm(sp, xs, ps, "ln1", cfg)
    mix = [p["mix"] for p in ps]
    if kind == "ssm":
        return sp.map(torch.add, xs, M2.mamba2_spmd(sp, mix, hs, cfg,
                                                     caches)), None
    if kind == "rec":
        out = RG.rglru_spmd(sp, mix, hs, cfg, caches)
    else:
        self_c = caches
        if kind == "dec" and caches is not None:
            self_c = [c["self"] for c in caches]
        out = C.attention_spmd(
            sp, mix, hs, cfg, positions, causal=kind != "enc",
            window=cfg.local_window if kind == "attn_local" else 0,
            kv_caches=self_c, cache_pos=cache_pos)
    xs = sp.map(torch.add, xs, out)
    if kind == "dec":
        hx = _norm(sp, xs, ps, "ln_x", cfg)
        xattn = [p["xattn"] for p in ps]
        if caches is None:
            xout = C.attention_spmd(sp, xattn, hx, cfg, None, causal=False,
                                    memory=memory)
        else:
            kv = ([c["cross"]["k"] for c in caches],
                  [c["cross"]["v"] for c in caches])
            xout = C.attention_spmd(sp, xattn, hx, cfg, None, causal=False,
                                    kv=kv)
        xs = sp.map(torch.add, xs, xout)
    hf = _norm(sp, xs, ps, "ln2", cfg)
    ffn = [p["ffn"] for p in ps]
    if kind == "moe":
        out, aux = MOE.moe_spmd(sp, ffn, hf, cfg)
        return sp.map(torch.add, xs, out), aux
    return sp.map(torch.add, xs, C.mlp_spmd(sp, ffn, hf, cfg)), None


def _add_aux(sp, total, aux):
    """Aux losses summed layer by layer (None: no layer has one yet)."""
    if aux is None or total is None:
        return total if aux is None else aux
    return sp.map(torch.add, total, aux)


def _stack_spmd(sp, params, xs, cfg: LMConfig, positions, *, caches=None,
                cache_pos=None):
    """The (super-)block stack and its tail partitioned (each super-block
    under `_remat` when training), as `_run_stack`; caches (placed,
    stacked) written in place. Returns (each device's output, the summed
    aux loss a device, or None where no layer has one)."""
    pat, n_super, tail = _kind_groups(layer_kinds(cfg))

    def block(layer_p, xs, layer_c):
        if len(pat) == 1:
            return _layer_spmd(sp, layer_p, xs, cfg, pat[0], positions,
                               caches=layer_c, cache_pos=cache_pos)
        aux = None
        for i, kind in enumerate(pat):
            xs, a = _layer_spmd(
                sp, layer_p[f"l{i}"], xs, cfg, kind, positions,
                caches=None if layer_c is None else [c[f"l{i}"]
                                                     for c in layer_c],
                cache_pos=cache_pos)
            aux = _add_aux(sp, aux, a)
        return xs, aux

    train = _remat(lambda lp, xs: block(lp, xs, None), cfg)
    aux = None
    for j in range(n_super):
        layer_p = _layer_slice(params["layers"], j)
        if caches is None:
            xs, a = train(layer_p, xs)
        else:
            xs, a = block(layer_p, xs, _cache_blocks(sp, caches["layers"],
                                                     j))
        aux = _add_aux(sp, aux, a)
    for i, kind in enumerate(tail):
        xs, a = _layer_spmd(
            sp, params[f"tail{i}"], xs, cfg, kind, positions,
            caches=None if caches is None else _cache_blocks(
                sp, caches[f"tail{i}"]), cache_pos=cache_pos)
        aux = _add_aux(sp, aux, a)
    return xs, aux


def _arange(xs, start: int = 0) -> list:
    return [start + torch.arange(x.shape[1], device=x.device) for x in xs]


def _encode_spmd(sp, params, cfg: LMConfig, enc) -> list:
    """The encoder stack over each device's frames -> its normed memory,
    replicated over 'model'."""
    _need_frames(cfg, enc)
    xs = [e.to(C.dt(cfg)) for e in enc]
    positions = _arange(xs)
    layer = _remat(lambda lp, xs: _layer_spmd(sp, lp, xs, cfg, "enc",
                                              positions)[0], cfg)
    for j in range(cfg.n_enc_layers):
        xs = layer(_layer_slice(params["enc"], j), xs)
    return _norm(sp, xs, sp.local({"ln_enc": params["ln_enc"]}), "ln_enc",
                 cfg)


def _train_logits(sp, params, cfg: LMConfig, toks, embeds=None,
                  enc=None):
    """(each device's vocab block of the training forward's logits, its
    aux loss or None)."""
    if cfg.family in ("encdec", "audio"):
        memory = _encode_spmd(sp, params, cfg, enc)
        xs = _embed_spmd(sp, params, cfg, toks)
        positions = _arange(xs)
        layer = _remat(lambda lp, xs: _layer_spmd(
            sp, lp, xs, cfg, "dec", positions, memory=memory)[0], cfg)
        for j in range(cfg.n_dec_layers):
            xs = layer(_layer_slice(params["dec"], j), xs)
        return _logits_spmd(sp, params, cfg, xs), None
    xs = _embed_spmd(sp, params, cfg, toks, embeds)
    xs, aux = _stack_spmd(sp, params, xs, cfg, _arange(xs))
    return _logits_spmd(sp, params, cfg, xs), aux


def _batch_parts(sp, tokens, embeds, enc_inputs):
    """Each device's rows of the tokens and of the modality inputs given."""
    return (_row_parts(sp, tokens, "tokens"),
            *(None if x is None else _row_parts(sp, x, name)
              for x, name in ((embeds, "embeds"),
                              (enc_inputs, "enc_inputs"))))


def _forward_spmd(sp, params, cfg: LMConfig, tokens, embeds=None,
                  enc_inputs=None):
    from repro_torch.dist import sharding as S

    parts = _batch_parts(sp, tokens, embeds, enc_inputs)
    logits, aux = _train_logits(sp, params, cfg, *parts)
    b, s = tokens.shape[0], logits[0].shape[1]
    return (_placed(sp, logits, ("batch", None, "vocab"),
                    (b, s, padded_vocab(cfg))),
            torch.zeros((), dtype=F32, device=logits[0].device)
            if aux is None else S.Sharded(aux, S.replicated(sp.mesh)))


def _loss_spmd(sp, params, cfg: LMConfig, batch):
    """The next-token cross-entropy over the vocab blocks: the max and the
    sum of exponentials psummed over 'model', the target's logit taken
    where it lies; each device's row sum psummed over the data axes the
    rows split over (rows replicated there are every device's whole);
    plus 0.01 x the MoE aux loss (already the global batch's)."""
    from repro_torch.dist import sharding as S

    tokens = batch["tokens"]
    toks, embeds, enc = _batch_parts(sp, tokens, batch.get("embeds"),
                                     batch.get("enc_inputs"))
    s = tokens.shape[1]
    logits, aux = _train_logits(sp, params, cfg, toks, embeds, enc)
    lf = [lg[:, -s:][:, :-1].to(F32) for lg in logits]
    top = S.pmax([t.amax(dim=-1, keepdim=True) for t in lf], sp.mesh,
                 ("model",))
    shifted = sp.map(torch.sub, lf, top)
    sumexp = sp.psum_model([torch.exp(t).sum(dim=-1) for t in shifted])
    vloc = lf[0].shape[-1]

    def target(t, tok, rank):
        idx = tok[:, 1:].long() - rank * vloc
        ok = (idx >= 0) & (idx < vloc)
        got = torch.gather(t, -1, idx.clamp(0, vloc - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros((), dtype=F32,
                                                device=t.device))

    picked = sp.psum_model(sp.map(target, shifted, toks, sp.rank))
    n = tokens.shape[0] * (s - 1)
    loss = sp.map(lambda t, e: -(t - torch.log(e)).sum() / n, picked,
                  sumexp)
    if sp.rows_split:
        loss = S.psum(loss, sp.mesh, sp.data_axes)
    if aux is not None:
        loss = sp.map(lambda x, a: x + 0.01 * a, loss, aux)
    return S.Sharded(loss, S.replicated(sp.mesh))


def cache_shardings(caches, mesh):
    """Placements of a cache tree (shape-fitted), keyed by leaf name as
    the reference's dry-run keys them (`dryrun.cache_shardings`): K/V split
    by batch and KV heads, their int8 scales the same, SSD states by batch
    and heads, conv states by batch and channels, RG-LRU states by batch
    and width, ring positions replicated."""
    from repro_torch.dist import sharding as S

    def mk(axes, leaf):
        spec = S._fit_spec_to_shape(S.logical_to_spec(axes, mesh),
                                    tuple(leaf.shape), mesh)
        return S.NamedSharding(mesh, spec)

    def one(key, leaf):
        nd = leaf.ndim
        if key in ("k", "v"):  # [(L,)? B, S, KV, hd]
            axes = ("batch", None, "heads", None)
        elif key in ("k_scale", "v_scale"):
            axes = ("batch", None, "heads")
        elif key == "ssd":
            axes = ("batch", "heads", None, None)
        elif key == "conv":
            axes = ("batch", None, "ffn")
        elif key == "h":
            axes = ("batch", "ffn")
        else:  # "pos" and anything else: replicated
            return mk((None,) * nd, leaf)
        return mk((None,) * (nd - len(axes)) + axes, leaf)

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return None if t is None else one(key, t)

    return walk(caches, None)


def _init_cache_spmd(sp, cfg: LMConfig, batch: int, max_len: int,
                     enc_len: int = 0):
    """Empty placed caches: each device's zero blocks (ring positions -1),
    laid out by `cache_shardings`."""
    from repro_torch.dist import sharding as S

    shapes = init_cache(cfg, batch, max_len, enc_len=enc_len, device="meta")
    shardings = cache_shardings(shapes, sp.mesh)
    devs = sp.mesh.device_list

    def one(leaf, sh, key):
        fill = -1 if key == "pos" else 0
        return S.Sharded([torch.full(
            [s.stop - s.start for s in S._slices(sh, i, leaf.shape)], fill,
            dtype=leaf.dtype, device=devs[i]) for i in sp.mesh.executed],
            sh)

    def walk(t, sh, key):
        if isinstance(t, dict):
            return {k: walk(v, sh[k], k) for k, v in t.items()}
        return one(t, sh, key)

    return walk(shapes, shardings, None)


def _dec_stack_spmd(sp, params, xs, cfg: LMConfig, positions, caches,
                    cache_pos=None) -> list:
    """The decoder layers against their self caches (written in place)
    and the cross K/V the caches hold."""
    for j in range(cfg.n_dec_layers):
        xs = _layer_spmd(sp, _layer_slice(params["dec"], j), xs, cfg, "dec",
                         positions, caches=_cache_blocks(sp, caches, j),
                         cache_pos=cache_pos)[0]
    return xs


def _prefill_spmd(sp, params, cfg: LMConfig, tokens, max_len: int,
                  embeds=None, enc_inputs=None):
    toks, embeds, enc = _batch_parts(sp, tokens, embeds, enc_inputs)
    b = tokens.shape[0]
    if cfg.family in ("encdec", "audio"):
        memory = _encode_spmd(sp, params, cfg, enc)
        caches = _init_cache_spmd(sp, cfg, b, max_len,
                                  enc_len=memory[0].shape[1])
        for j in range(cfg.n_dec_layers):
            ps = sp.local(_layer_slice(params["dec"], j))
            k, v = C.cross_kv_spmd(sp, [p["xattn"] for p in ps], memory, cfg)
            for c, kk, vv in zip(_cache_blocks(sp, caches["cross"], j), k,
                                 v):
                c["k"].copy_(kk)
                c["v"].copy_(vv)
        xs = _embed_spmd(sp, params, cfg, toks)
        xs = _dec_stack_spmd(sp, params, xs, cfg, _arange(xs), caches)
    else:
        caches = _init_cache_spmd(sp, cfg, b, max_len)
        xs = _embed_spmd(sp, params, cfg, toks, embeds)
        xs, _ = _stack_spmd(sp, params, xs, cfg, _arange(xs),
                            caches=caches)
    logits = _logits_spmd(sp, params, cfg, [x[:, -1:] for x in xs])
    return (_placed(sp, logits, ("batch", None, "vocab"),
                    (b, 1, padded_vocab(cfg))), caches)


def _decode_spmd(sp, params, cfg: LMConfig, token, caches, pos: int):
    toks = _row_parts(sp, token, "token")
    xs = _embed_spmd(sp, params, cfg, toks)
    positions = _arange(xs, pos)
    if cfg.family in ("encdec", "audio"):
        xs = _dec_stack_spmd(sp, params, xs, cfg, positions, caches, pos)
    else:
        xs, _ = _stack_spmd(sp, params, xs, cfg, positions, caches=caches,
                            cache_pos=pos)
    logits = _logits_spmd(sp, params, cfg, xs)
    return (_placed(sp, logits, ("batch", None, "vocab"),
                    (token.shape[0], 1, padded_vocab(cfg))), caches)


__all__ = [
    "init_params", "forward_train", "loss_fn", "init_cache", "prefill",
    "decode_step", "layer_kinds", "cache_logical", "padded_vocab",
    "embed_tokens", "logits_from_hidden", "tree_map", "cache_shardings",
]
