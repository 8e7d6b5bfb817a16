"""Per-request sampling for the serving loop (counterpart of
paddle_tpu/serving/sampling.py; the port keeps its own copy of every
function so that it imports nothing of the JAX package).

- :class:`SamplingParams` is the immutable per-request value carried on
  ``DecodeRequest.sampling``: temperature, top-k, top-p, stop sequences,
  logit bias, a per-request ``max_new`` cap and a uint32 ``seed``.
  ``temperature == 0`` (the default) is exact greedy: the loop takes the
  host argmax, bit-identical to ``full_decode``.
- :func:`sample_rows` is the sampling epilogue: one batched call over
  the step's [B, V] logits, on their device — temperature scaling,
  top-k and top-p filtering, and a Gumbel-max draw keyed by (request
  seed, generated-token index g) through ``fold_in(PRNGKey(seed), g)``.
  The stream is JAX's own threefry (``_threefry``), so a request draws
  the same tokens as in the JAX package, and batch composition never
  moves a request's stream.
- :func:`spec_sample_rows` is the exact accept/resample epilogue for
  drafted sampled rows over a verify step's [B, Sq, V] logits: draft d
  is accepted with probability p(d) (the prompt-lookup drafter proposes
  a point mass), a rejection resamples p with d's mass removed, and both
  arms marginalise to p.  Accept uniforms draw from ``fold_in(key_g,
  1)``, residual Gumbels from ``fold_in(key_g, 2)``, the bonus draw from
  key_g itself (the draw :func:`sample_rows` makes); rolled-back rows
  consume no index.
- Logit bias is added before everything, greedy rows included
  (:func:`apply_bias` on a host row, :func:`bias_rows` on the device's
  rows: the same float32 adds in the same order); stop sequences are a
  host suffix check (:func:`stop_hit`) after every emitted token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _threefry

__all__ = ["SamplingParams", "apply_bias", "bias_rows", "decision_margins",
           "sample_rows", "spec_sample_rows", "stop_hit"]

ACCEPT_SALT = 1  # fold_in salt of the accept uniforms
RESIDUAL_SALT = 2  # fold_in salt of the residual Gumbels


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Immutable per-request sampling knobs.

    temperature: 0.0 (default) = exact greedy (argmax, verified by the
        longest-prefix walk); > 0 samples from the scaled distribution
        (verified by the accept/resample epilogue).
    top_k: keep the k highest logits (0 = off; ties at the threshold
        stay in).
    top_p: keep the smallest probability-sorted prefix whose mass
        reaches p (1.0 = off; the top-1 token always stays).
    stop: stop token sequences; a sequence retires once its generated
        tokens end with one of them (the stop tokens stay in the output).
    logit_bias: {token_id: additive bias} on every step's logits before
        argmax or sampling, greedy rows included.
    max_new: per-request cap; the effective cap is
        ``min(DecodeRequest.max_new_tokens, max_new)``.
    seed: the request's uint32 stream; the g-th generated token draws
        from ``fold_in(PRNGKey(seed), g)``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: Tuple[Tuple[int, ...], ...] = ()
    logit_bias: Optional[Tuple[Tuple[int, float], ...]] = None
    max_new: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new is not None and self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if not 0 <= int(self.seed) < 2 ** 32:
            # a bad seed fails this request's construction, never the
            # shared batch mid-step
            raise ValueError(
                f"seed must be a uint32 (0 <= seed < 2**32), got "
                f"{self.seed}")
        # normalised containers: the frozen instance is hashable
        object.__setattr__(self, "stop", tuple(
            tuple(int(t) for t in s) for s in (self.stop or ())))
        if any(not s for s in self.stop):
            raise ValueError("stop sequences must be non-empty")
        bias = self.logit_bias
        if bias is not None:
            if isinstance(bias, dict):
                bias = bias.items()
            norm = tuple(sorted((int(t), float(b)) for t, b in bias))
            if norm and norm[0][0] < 0:
                raise ValueError(
                    f"logit_bias token ids must be >= 0, got {norm[0][0]}")
            object.__setattr__(self, "logit_bias", norm or None)

    def max_bias_token(self) -> int:
        """Largest biased token id (-1 without bias): the loop checks it
        against the vocab before any work."""
        return self.logit_bias[-1][0] if self.logit_bias else -1

    @property
    def greedy(self) -> bool:
        """True when the choice is the deterministic argmax."""
        return self.temperature == 0.0


def apply_bias(row: np.ndarray,
               params: Optional[SamplingParams]) -> np.ndarray:
    """Host logit bias for one [V] row: a float32 copy with each entry's
    bias added in order (the input row when no bias applies)."""
    if params is None or not params.logit_bias:
        return row
    out = np.asarray(row, np.float32).copy()
    for tok, b in params.logit_bias:
        out[tok] += np.float32(b)
    return out


def bias_rows(rows: torch.Tensor,
              params: Sequence[Optional[SamplingParams]]) -> torch.Tensor:
    """:func:`apply_bias` over rows [R, V] or [R, Sq, V] on their device
    (row i under ``params[i]``; every [V] slice of a row biased alike).
    A token listed twice gets its biases in :func:`apply_bias`'s order,
    one index pass per repeat.  Returns ``rows`` itself when no row has
    a bias."""
    entries = []  # (row, token, bias, repeat)
    for i, p in enumerate(params):
        if p is None or not p.logit_bias:
            continue
        prev, rep = None, 0
        for tok, b in p.logit_bias:
            rep = rep + 1 if tok == prev else 0
            entries.append((i, tok, b, rep))
            prev = tok
    if not entries:
        return rows
    out = rows.float().clone()
    view = out if out.dim() == 3 else out[:, None, :]
    for rep in range(max(e[3] for e in entries) + 1):
        sel = [e for e in entries if e[3] == rep]
        r = torch.as_tensor([e[0] for e in sel], device=out.device)
        t = torch.as_tensor([e[1] for e in sel], device=out.device)
        b = torch.as_tensor([e[2] for e in sel], dtype=torch.float32,
                            device=out.device)
        view[r, :, t] = view[r, :, t] + b[:, None]
    return out


def stop_hit(tokens: Sequence[int],
             params: Optional[SamplingParams]) -> bool:
    """True when ``tokens`` (the generated tokens so far) ends with one
    of the request's stop sequences."""
    if params is None or not params.stop:
        return False
    for s in params.stop:
        n = len(s)
        if n <= len(tokens) and tuple(tokens[-n:]) == s:
            return True
    return False


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's arithmetic: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _top_k_scaled(logits, temps, top_ks):
    """Temperature, then top-k: everything below the k-th largest scaled
    logit goes to -inf (ties at the threshold stay; k = 0 keeps all)."""
    vocab = logits.shape[-1]
    x = logits / temps.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    k = torch.where(top_ks > 0, top_ks, vocab).clamp(1, vocab)
    kth = sorted_desc.gather(-1, (k - 1)[:, None])
    return torch.where(x >= kth, x, -torch.inf)


def _filter_scaled(logits, temps, top_ks, top_ps):
    """Temperature, top-k and top-p over [R, V] rows, in the reference's
    order -> the filtered scaled logits, excluded tokens at -inf.  Both
    epilogues call this, so they share one decision surface."""
    x = _top_k_scaled(logits, temps, top_ks)
    # top-p: keep every token whose preceding mass is < p (the top-1's is
    # 0, and top_p = 1.0 keeps everything though the float32 cumsum may
    # stop short of 1)
    probs = _softmax(x)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    preceding = torch.cumsum(p_desc, dim=-1) - p_desc
    kept = preceding < top_ps[:, None]
    p_min = torch.where(kept, p_desc, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(probs >= p_min, x, -torch.inf)


def _knobs(params: Sequence[SamplingParams], device):
    """Per-row (temperature, top_k, top_p, seed) tensors on ``device``."""
    t = lambda v, dt: torch.as_tensor(v, dtype=dt, device=device)  # noqa
    return (t([p.temperature for p in params], torch.float32),
            t([p.top_k for p in params], torch.int64),
            t([p.top_p for p in params], torch.float32),
            t([int(p.seed) for p in params], torch.int64))


def _key_g(seeds: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """fold_in(PRNGKey(seed), g) for every (seed, g), broadcast."""
    return _threefry.fold_in(_threefry.key(seeds), g)


def _salt(key_g: torch.Tensor, salt: int) -> torch.Tensor:
    """key_g folded with a salt (the planted-fault checks replace this)."""
    return _threefry.fold_in(key_g, salt)


def _as_float32(logits) -> torch.Tensor:
    if isinstance(logits, torch.Tensor):
        return logits.float()
    return torch.as_tensor(np.asarray(logits, np.float32))


def _refuse_greedy(params: Sequence[SamplingParams], where: str) -> None:
    if any(p.temperature <= 0 for p in params):
        raise ValueError(
            f"greedy rows (temperature 0) must take the host {where}, not "
            "the sampling epilogue")


def sample_rows(logits, params: Sequence[SamplingParams],
                steps: Sequence[int]) -> np.ndarray:
    """Sample a next token for every row of ``logits`` [B, V] (a tensor,
    computed on its device, or a host array, on the CPU) under its
    request's non-greedy params; ``steps[i]`` is row i's generated-token
    index g.  Bias must already be applied.  Returns [B] int32 tokens on
    the host."""
    x = _as_float32(logits)
    if x.dim() != 2:
        raise ValueError(f"sample_rows wants [B, V] rows, got "
                         f"{tuple(x.shape)}")
    B, V = x.shape
    if len(params) != B or len(steps) != B:
        raise ValueError("params/steps must align with the logit rows")
    _refuse_greedy(params, "argmax path")
    g = torch.as_tensor([int(s) for s in steps], dtype=torch.int64,
                        device=x.device)
    tokens = _draw(x, _knobs(params, x.device), g)
    return tokens.to(torch.int32).cpu().numpy()


def _draw(x: torch.Tensor, knobs, g: torch.Tensor) -> torch.Tensor:
    """The plain epilogue on device tensors alone: x [B, V] float32, the
    per-row knobs of :func:`_knobs`, g [B] int64 -> [B] tokens."""
    temps, top_ks, top_ps, seeds = knobs
    xf = _filter_scaled(x, temps, top_ks, top_ps)
    return (xf + _threefry.gumbel(_key_g(seeds, g), x.shape[-1])).argmax(-1)


def spec_sample_rows(logits, params: Sequence[SamplingParams],
                     steps: Sequence[int], drafts: Sequence[Sequence[int]],
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The accept/resample epilogue over a verify step's [B, Sq, V]
    logits (bias applied to every [Sq, V] slice) on their device.
    ``drafts[i]`` is row i's proposal (its block less the committed head;
    at most Sq - 1 tokens, possibly none), ``steps[i]`` the index g of
    its first emitted token; position t owns index g + t.  Returns
    ``(accepted [B], tokens [B, Sq])`` int32 on the host: position t
    holds the accepted draft for ``t < accepted[i]``, then the residual
    resample, or the bonus draw where every draft landed; entries past
    each row's walk are garbage."""
    x = _as_float32(logits)
    if x.dim() != 3:
        raise ValueError(f"spec_sample_rows wants [B, Sq, V] verify "
                         f"logits, got {tuple(x.shape)}")
    B, Sq, V = x.shape
    if len(params) != B or len(steps) != B or len(drafts) != B:
        raise ValueError(
            "params/steps/drafts must align with the logit rows")
    _refuse_greedy(params, "longest-prefix walk")
    draft_arr = np.zeros((B, Sq), np.int64)
    q_lens = np.empty(B, np.int64)
    for i, d in enumerate(drafts):
        d = [int(t) for t in d]
        if len(d) >= Sq:
            raise ValueError(
                f"row {i} proposes {len(d)} drafts but the verify width "
                f"holds at most {Sq - 1} (1 committed + drafts)")
        draft_arr[i, :len(d)] = d
        q_lens[i] = len(d) + 1
    dev = x.device
    g = torch.as_tensor([int(s) for s in steps], dtype=torch.int64,
                        device=dev)
    acc, tokens = _spec_draw(x, _knobs(params, dev), g,
                             torch.as_tensor(draft_arr, device=dev),
                             torch.as_tensor(q_lens, device=dev))
    return (acc.to(torch.int32).cpu().numpy(),
            tokens.to(torch.int32).cpu().numpy())


def _spec_draw(x: torch.Tensor, knobs, g: torch.Tensor,
               drafts: torch.Tensor, q_lens: torch.Tensor):
    """The accept/resample epilogue on device tensors alone: x [B, Sq, V]
    float32, the per-row knobs, g [B] (row i's first index), drafts [B,
    Sq] (zero-padded), q_lens [B] (drafts + 1) -> (accepted [B], tokens
    [B, Sq])."""
    temps, top_ks, top_ps, seeds = knobs
    B, Sq, V = x.shape
    dev = x.device
    rep = lambda a: a.repeat_interleave(Sq)  # noqa: E731
    xf = _filter_scaled(x.reshape(B * Sq, V), rep(temps), rep(top_ks),
                        rep(top_ps)).reshape(B, Sq, V)
    probs = _softmax(xf)
    t_iota = torch.arange(Sq, device=dev)
    key_g = _key_g(seeds[:, None], g[:, None] + t_iota[None, :])  # [B,Sq,2]
    u = _threefry.uniform(_salt(key_g, ACCEPT_SALT), 1)[..., 0]
    g_resid = _threefry.gumbel(_salt(key_g, RESIDUAL_SALT), V)
    g_plain = _threefry.gumbel(key_g, V)
    q_t = q_lens[:, None]
    # draft t is accepted iff u_t < p(d_t); the cumprod keeps acceptance
    # a prefix (the first rejection ends the row's walk)
    p_draft = probs.gather(-1, drafts[..., None])[..., 0]
    accept = (u < p_draft) & (t_iota[None, :] < q_t - 1)
    acc = accept.long().cumprod(dim=1).sum(dim=1)
    v_iota = torch.arange(V, device=dev)
    x_masked = torch.where(v_iota == drafts[..., None], -torch.inf, xf)
    resid_tok = (x_masked + g_resid).argmax(dim=-1)
    plain_tok = (xf + g_plain).argmax(dim=-1)
    is_bonus = t_iota[None, :] == q_t - 1
    tokens = torch.where(t_iota[None, :] < acc[:, None], drafts,
                         torch.where(is_bonus, plain_tok, resid_tok))
    return acc, tokens


def decision_margins(logits, params: Sequence[SamplingParams],
                     steps: Sequence[int],
                     drafts: Optional[Sequence[Sequence[int]]] = None,
                     ) -> np.ndarray:
    """How far each row's outcome stands from a flip: a relative margin
    per row, the smallest over the decisions its outcome depends on,
    from this module's arithmetic on the CPU (float32 values, float64
    gaps).  ``logits`` and the arguments as :func:`sample_rows`, or with
    ``drafts`` as :func:`spec_sample_rows` (positions past a row's block
    ignored).  The decisions:

    - a Gumbel-max draw: the gap of its top two scores over max(1, |top|);
    - an accept: |u - p(d)| over max(u, p(d));
    - the top-p boundary (top_p < 1): the nearest preceding mass to
      top_p, over top_p — counted only where moving the boundary by one
      token (the last kept in, the first dropped) changes the draw or
      the accept.

    Two implementations whose inputs agree up to float32 rounding (XLA's
    and torch's logs and sums, the card's and the host's) can choose
    differently only on rows whose margin is a few ulps."""
    x = _as_float32(logits).cpu()
    if drafts is None:
        x, drafts = x[:, None, :], [[] for _ in params]
    B, Sq, V = x.shape
    temps, top_ks, top_ps, seeds = (
        a.repeat_interleave(Sq) for a in _knobs(params, "cpu"))
    flat = x.reshape(B * Sq, V)
    xk = _top_k_scaled(flat, temps, top_ks)
    kept = torch.isfinite(_filter_scaled(flat, temps, top_ks, top_ps))
    # the top-p boundary: the last token kept and the first one dropped,
    # in probability order
    p_desc, order = torch.sort(_softmax(xk), dim=-1, descending=True)
    preceding = (torch.cumsum(p_desc, dim=-1) - p_desc).double()
    n_kept = kept.sum(-1, keepdim=True)
    n_fin = torch.isfinite(xk).sum(-1, keepdim=True)
    nucleus = (top_ps < 1)[:, None]
    has_next = nucleus & (n_kept < n_fin)
    at = torch.cat([n_kept - 1, n_kept.clamp(max=V - 1)], dim=-1)
    tp = top_ps.double()[:, None]
    m_p = torch.where(torch.cat([nucleus, has_next], dim=-1),
                      (preceding.gather(-1, at) - tp).abs() / tp,
                      torch.inf).amin(-1)
    v = torch.arange(V)
    last, nxt = order.gather(-1, at).unbind(-1)
    sets = (kept, kept | ((v == nxt[:, None]) & has_next),
            kept & ~((v == last[:, None]) & nucleus & (n_kept > 1)))
    xd = xk.double()

    def draw(noise, allowed):
        """(relative top-2 gap over the kept set, winners differ between
        the three boundary sets)."""
        z = xd + noise.double()
        wins = [torch.where(s & allowed, z, -torch.inf).argmax(-1)
                for s in sets]
        top2 = torch.where(sets[0] & allowed, z, -torch.inf).topk(2).values
        gap = torch.where(torch.isfinite(top2[:, 1]),
                          (top2[:, 0] - top2[:, 1])
                          / top2[:, 0].abs().clamp_min(1.0), torch.inf)
        return gap, (wins[1] != wins[0]) | (wins[2] != wins[0])

    g = torch.as_tensor([int(s) for s in steps], dtype=torch.int64)
    key_g = _key_g(seeds, g.repeat_interleave(Sq) + torch.arange(Sq).repeat(B))
    gap, flip = draw(_threefry.gumbel(key_g, V), torch.ones(V, dtype=bool))
    m = torch.minimum(gap, torch.where(flip, m_p, torch.inf))
    t = torch.arange(Sq).repeat(B)
    q = torch.as_tensor([len(d) + 1 for d in drafts]).repeat_interleave(Sq)
    d = torch.zeros(B, Sq, dtype=torch.int64)
    for i, dr in enumerate(drafts):
        d[i, :len(dr)] = torch.as_tensor([int(tok) for tok in dr],
                                         dtype=torch.int64)
    d = d.reshape(-1)
    m = torch.where(t == q - 1, m, torch.inf)
    if (q > 1).any():
        # drafted positions: the accept and the residual draw
        gap_r, flip_r = draw(
            _threefry.gumbel(_salt(key_g, RESIDUAL_SALT), V),
            v != d[:, None])
        u = _threefry.uniform(_salt(key_g, ACCEPT_SALT), 1)[:, 0].double()
        p_d = [torch.where(s, xd, -torch.inf).softmax(-1).gather(
            -1, d[:, None])[:, 0] for s in sets]
        acc = [u < p for p in p_d]
        flip_a = (acc[1] != acc[0]) | (acc[2] != acc[0])
        m_acc = (u - p_d[0]).abs() / torch.maximum(u, p_d[0]).clamp_min(
            1e-30)
        m_d = torch.minimum(torch.minimum(m_acc, gap_r),
                            torch.where(flip_a | flip_r, m_p, torch.inf))
        m = torch.where(t < q - 1, m_d, m)
    return m.reshape(B, Sq).amin(dim=1).numpy()
