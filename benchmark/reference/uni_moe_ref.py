"""Plain float32 Uni-MoE-2.0-Omni speech-to-text path (HIT-TMG's
``grin_qwen2_vl``), written from its equations, that judges what the port
served.

It reads a state_dict of one tensor a part (the layout below), a waveform,
the chat template's ids around the audio and each window's forced token
sequence, and works out again what the port derives from them: each 30 s
window of the file (``whisper_ref``'s log-mel and window plan), the
Whisper-large tower (``whisper_ref.Model.encode``), the connector, and the
language model over [ids before, audio tokens, ids after, forced tokens],
whose logits give the log-probability of each forced token.  It imports nothing of the port and
no JAX, and keeps no cache and no batch: each window's sequence runs whole.

The language model, x a row of the residual stream:

- connector: audio token i is the mean of the tower's frames [floor(i T /
  n), ceil((i + 1) T / n)) (T frames, n tokens), then a linear layer with
  bias;
- block: ``h = x + Attn(RMSNorm(x)); x' = h + MoE(RMSNorm(h))``, RMSNorm
  ``w x / sqrt(mean(x^2) + eps)``; Attn: q, k and v with biases, o
  without, KVH K/V heads each shared by H / KVH query heads (query head j
  reads K/V head j // (H / KVH)), RoPE rotate-half with theta at the
  sequence's positions, causal softmax(q k^T / sqrt(D)) v;
- MoE: p = softmax(x W_r) over the routed experts and the null expert
  (last); sorted descending, the first k = min(top_k, 1 + #{j : cumsum_j <
  top_p}) are picked; ``MoE(x) = sum over picked routed e of p_e E_e(x) +
  sum over the shared experts s of S_s(x)``, E and S SwiGLU ``W_down
  (silu(W_gate x) * W_up x)``; a picked null expert adds nothing, and the
  weights are not renormalised;
- head: RMSNorm, then an untied projection.

The state_dict: ``encoder.*`` (openai/whisper's keys), ``connector.weight``
and ``.bias``, ``embed_tokens.weight``, per layer i ``layers.{i}.``
``input_norm.weight``, ``attn.{q,k,v}.{weight,bias}``, ``attn.o.weight``,
``post_norm.weight``, ``moe.router.weight`` (the null expert's row last),
``moe.experts.{e}.{gate,up,down}.weight``,
``moe.shared.{s}.{gate,up,down}.weight``; ``norm.weight``,
``lm_head.weight``.  It stays in its own dtype; a layer's weights are read
in float32 when the layer runs, so that the reference of a 26 B model
needs its state and one layer in float32 besides.

Every product runs in float32 with TF32 off (``use_float32``);
``products="fp8"`` rounds both operands of every product to float8 e4m3
first (``whisper_ref.fp8``): the reference in the precision below the
configuration's, which the comparison has to fail.
"""

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import whisper_ref

use_float32 = whisper_ref.use_float32
SAMPLE_RATE, HOP_LENGTH = whisper_ref.SAMPLE_RATE, whisper_ref.HOP_LENGTH
N_SAMPLES, N_FRAMES = whisper_ref.N_SAMPLES, whisper_ref.N_FRAMES

TOWER_KEYS = ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer")


def window_plan(n_samples: int) -> List[Dict]:
    """The consecutive 30 s windows of a file of n_samples: each one's
    start frame and its frames of the file."""
    content = (n_samples + N_SAMPLES) // HOP_LENGTH - N_FRAMES
    plan, seek = [], 0
    while seek < content:
        size = min(N_FRAMES, content - seek)
        plan.append(dict(seek=seek, size=size, start=seek * HOP_LENGTH / SAMPLE_RATE,
                         end=(seek + size) * HOP_LENGTH / SAMPLE_RATE))
        seek += size
    return plan


def picks(probs: torch.Tensor, top_p: float, top_k: int) -> torch.Tensor:
    """(N, E + E0) bool: each row's picked experts, the first k = min(top_k,
    1 + #{j : cumsum_j < top_p}) of its probabilities sorted descending."""
    sorted_p, order = torch.sort(probs, dim=-1, descending=True)
    k = (1 + (sorted_p.cumsum(-1) < top_p).sum(-1)).clamp(max=top_k)
    ranked = torch.arange(probs.shape[-1], device=probs.device)[None, :] < k[:, None]
    return torch.zeros_like(ranked).scatter(-1, order, ranked)


class Model:
    """The speech-to-text path over a state_dict (module docstring)."""

    def __init__(self, state: Dict[str, torch.Tensor], dims: Dict, device, products: str = "float32"):
        self.state, self.dims, self.device = state, dims, device
        self.fp8 = products == "fp8"
        self.q = whisper_ref.fp8 if self.fp8 else (lambda t: t)
        tower = {k: v for k, v in state.items() if k.startswith("encoder.")}
        self.tower = whisper_ref.Model(tower, {k: dims[k] for k in TOWER_KEYS}, device, products)

    def w(self, key: str) -> torch.Tensor:
        """A tensor of the state in float32 (a matrix rounded to float8 per
        row under the control)."""
        t = self.state[key].to(device=self.device, dtype=torch.float32)
        return whisper_ref.fp8(t) if self.fp8 and t.dim() == 2 else t

    def _lin(self, x, weight, bias=None):
        return F.linear(self.q(x), weight, bias)

    def _norm(self, x, weight):
        eps = self.dims["rms_eps"]
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight

    def audio_tokens(self, features: torch.Tensor) -> torch.Tensor:
        """Tower features (T, Ca) -> (n_audio_tokens, C)."""
        T, n = features.shape[0], self.dims["n_audio_tokens"]
        pooled = torch.stack([features[(i * T) // n : -((-(i + 1) * T) // n)].mean(0) for i in range(n)])
        return self._lin(pooled, self.w("connector.weight"), self.w("connector.bias"))

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, heads, D) rotated at positions 0..N-1."""
        N, D = x.shape[0], x.shape[-1]
        inv = 1.0 / self.dims["rope_theta"] ** (torch.arange(0, D, 2, dtype=torch.float64) / D)
        angles = torch.arange(N, dtype=torch.float64)[:, None] * inv[None, :]
        angles = torch.cat([angles, angles], dim=-1).to(self.device)
        cos, sin = angles.cos().float()[:, None], angles.sin().float()[:, None]
        rotated = torch.cat([-x[..., D // 2 :], x[..., : D // 2]], dim=-1)
        return x * cos + rotated * sin

    def _attention(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        N = x.shape[0]
        H, KVH = self.dims["n_head"], self.dims["n_kv_head"]
        D = self.dims["n_state"] // H
        q = self._rope(self._lin(x, w["attn.q.weight"], w["attn.q.bias"]).view(N, H, D))
        k = self._rope(self._lin(x, w["attn.k.weight"], w["attn.k.bias"]).view(N, KVH, D))
        v = self._lin(x, w["attn.v.weight"], w["attn.v.bias"]).view(N, KVH, D)
        group = torch.arange(H, device=x.device) // (H // KVH)  # the K/V head of each query head
        k, v = k[:, group].transpose(0, 1), v[:, group].transpose(0, 1)  # (H, N, D)
        scores = self.q(q.transpose(0, 1)) @ self.q(k).transpose(1, 2) / math.sqrt(D)
        scores = scores + torch.full((N, N), float("-inf"), device=x.device).triu(1)
        out = self.q(torch.softmax(scores, dim=-1)) @ self.q(v.transpose(1, 2)).transpose(1, 2)
        return self._lin(out.transpose(0, 1).reshape(N, H * D), w["attn.o.weight"])

    def _swiglu(self, x, w, name):
        h = F.silu(self._lin(x, w[name + ".gate.weight"])) * self._lin(x, w[name + ".up.weight"])
        return self._lin(h, w[name + ".down.weight"])

    def moe(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        probs = torch.softmax(self._lin(x, w["moe.router.weight"]), dim=-1)
        picked = picks(probs, self.dims["top_p"], self.dims["top_k"])
        out = torch.zeros_like(x)
        for e in range(self.dims["n_expert"]):  # the null experts add nothing
            rows = picked[:, e].nonzero()[:, 0]
            if len(rows):
                out[rows] += probs[rows, e, None] * self._swiglu(x[rows], w, f"moe.experts.{e}")
        for s in range(self.dims["n_shared"]):
            out += self._swiglu(x, w, f"moe.shared.{s}")
        return out

    def _block(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = x + self._attention(self._norm(x, w["input_norm.weight"]), w)
        return h + self.moe(self._norm(h, w["post_norm.weight"]), w)

    def logits(self, mels: Sequence[torch.Tensor], before: Sequence[int], after: Sequence[int],
               forced: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """The logits (F, V) that choose each forced token in each window
        (mel (n_mels, 3000), and its forced tokens) after [before, its
        audio tokens, after]: the model over [before, audio, after,
        forced[:-1]], each layer run over every window's sequence before
        the next layer is read."""
        embed = self.state["embed_tokens.weight"]

        def ids(seq):
            return embed[torch.tensor(list(seq), device=embed.device)].to(self.device, torch.float32)

        xs = [torch.cat([ids(before), self.audio_tokens(self.tower.encode(mel)), ids(after),
                         ids(f[:-1])]) for mel, f in zip(mels, forced)]
        for i in range(self.dims["n_layer"]):
            prefix = f"layers.{i}."
            w = {k[len(prefix):]: self.w(k) for k in self.state if k.startswith(prefix)}
            xs = [self._block(x, w) for x in xs]
            del w
        norm, head = self.w("norm.weight"), self.w("lm_head.weight")
        return [self._lin(self._norm(x[-len(f):], norm), head) for x, f in zip(xs, forced)]

    def forced_logprobs(self, mels: Sequence[torch.Tensor], before: Sequence[int], after: Sequence[int],
                        forced: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """The log-probability of each forced token (F,) in each window."""
        out = []
        for logits, f in zip(self.logits(mels, before, after, forced), forced):
            target = torch.tensor(list(f), device=self.device)[:, None]
            out.append(torch.log_softmax(logits, dim=-1).gather(1, target)[:, 0])
        return out


def judge_files(model: Model, waves: Sequence[np.ndarray], before, after, forced) -> List[List[Dict]]:
    """What the reference expects of each window of each file: its seek,
    times and tokens (its forced ids before the stop token, ``forced(k,
    seek)`` for the window at frame ``seek`` of wave k), and the
    log-probability of each forced token and their mean."""
    plans, mels, ids = [], [], []
    for k, wave in enumerate(waves):
        mel = whisper_ref.log_mel(wave, model.dims["n_mels"], model.device)
        plan = window_plan(len(wave))
        plans.append(plan)
        mels += [F.pad(mel[:, w["seek"] : w["seek"] + w["size"]], (0, N_FRAMES - w["size"])) for w in plan]
        ids += [list(forced(k, w["seek"])) for w in plan]
    logprobs = iter(zip(ids, model.forced_logprobs(mels, before, after, ids)))
    out = []
    for plan in plans:
        out.append([])
        for w in plan:
            f, lp = next(logprobs)
            out[-1].append(dict(w, tokens=f[:-1], token_logprobs=lp.tolist(), avg_logprob=float(lp.mean())))
    return out
