"""Plain float32 Whisper, written from the published architecture
(openai/whisper ``whisper/model.py``, ``audio.py``, ``decoding.py``), that
judges what the port served.

It reads an official-layout ``state_dict`` (``encoder.blocks.0.attn.query.weight``
and so on), a waveform and a forced token sequence, and works out again
everything the port derives from them: the mel filterbank (librosa's Slaney
formula), the log-mel of the whole file, each 30 s window, the encoder, the
cross-attention K/V, the prompt of each window, the decoder over prompt and
forced tokens, the logit filters of greedy timestamped decoding, and the
segment that each window yields.  It imports nothing of the port and no JAX.

Every product runs in float32 with TF32 off (``use_float32``).
"""

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH
TIME_PRECISION = 0.02  # seconds per timestamp token: 2 mel frames of 10 ms
MAX_INITIAL_TIMESTAMP_INDEX = 50  # DecodingOptions.max_initial_timestamp = 1.0 s
PROMPT_MAX = 223  # n_text_ctx // 2 - 1 tokens of the previous text


def use_float32() -> None:
    """Float32 products without TF32, on the card and in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels) (Slaney mel
    scale, Slaney area normalisation), as float32 (n_mels, 201)."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        mel = f / f_sp
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, mel)

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)

    fftfreqs = np.fft.rfftfreq(N_FFT, 1.0 / SAMPLE_RATE)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(wave: np.ndarray, n_mels: int, device) -> torch.Tensor:
    """The log-mel (n_mels, frames) of a whole file with 30 s of zeros
    appended (whisper's transcribe), its floor at the file's maximum - 8."""
    audio = torch.from_numpy(np.asarray(wave, np.float32)).to(device)
    audio = F.pad(audio, (0, N_SAMPLES))
    stft = torch.stft(audio, N_FFT, HOP_LENGTH, window=torch.hann_window(N_FFT, device=device),
                      return_complex=True)
    power = stft[..., :-1].abs() ** 2
    spec = torch.from_numpy(mel_filters(n_mels)).to(device) @ power
    spec = torch.clamp(spec, min=1e-10).log10()
    spec = torch.maximum(spec, spec.max() - 8.0)
    return (spec + 4.0) / 4.0


def sinusoids(length: int, channels: int) -> torch.Tensor:
    increment = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-increment * torch.arange(channels // 2, dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 (per row of its last axis, scaled so that
    the row's largest value is e4m3's largest, 448), back in float32."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """Whisper's forward passes over a float32 copy of a state_dict.

    ``products="fp8"`` rounds both operands of every product (the
    projections, the convolutions, attention's two products and the
    logits) to float8 e4m3 first: the reference in the precision below
    the configuration's, which the comparison has to fail."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], dims: Dict[str, int], device,
                 products: str = "float32"):
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in state_dict.items()
                  if k != "encoder.positional_embedding"}
        self.dims = dims
        self.device = device
        self.pos = sinusoids(dims["n_audio_ctx"], dims["n_audio_state"]).to(device)
        self.q = fp8 if products == "fp8" else (lambda t: t)
        if products == "fp8":
            for k, v in self.w.items():
                if v.dim() >= 2 and k != "decoder.positional_embedding":
                    self.w[k] = fp8(v.reshape(v.shape[0], -1)).reshape(v.shape)

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"], 1e-5)

    def _lin(self, x, name, bias=True):
        return F.linear(self.q(x), self.w[name + ".weight"], self.w[name + ".bias"] if bias else None)

    def _attention(self, x, kv, name, n_head, causal):
        q = self._lin(x, name + ".query")
        k = self._lin(kv, name + ".key", bias=False)
        v = self._lin(kv, name + ".value")
        (T, C), S = q.shape, k.shape[0]
        q = q.view(T, n_head, -1).transpose(0, 1)
        k = k.view(S, n_head, -1).transpose(0, 1)
        v = v.view(S, n_head, -1).transpose(0, 1)
        scores = (self.q(q) @ self.q(k).transpose(1, 2)) / math.sqrt(C // n_head)
        if causal:
            scores = scores + torch.full((T, S), float("-inf"), device=x.device).triu(1)
        out = self.q(torch.softmax(scores, dim=-1)) @ self.q(v.transpose(1, 2)).transpose(1, 2)
        return self._lin(out.transpose(0, 1).reshape(T, C), name + ".out")

    def _mlp(self, x, name):
        return self._lin(F.gelu(self._lin(x, name + ".mlp.0")), name + ".mlp.2")

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (n_mels, 3000) -> audio features (1500, n_audio_state)."""
        q = lambda t: self.q(t.transpose(1, 2)).transpose(1, 2)  # per time step
        x = F.gelu(F.conv1d(q(mel[None]), self.w["encoder.conv1.weight"], self.w["encoder.conv1.bias"], padding=1))
        x = F.gelu(F.conv1d(q(x), self.w["encoder.conv2.weight"], self.w["encoder.conv2.bias"], stride=2, padding=1))
        x = x[0].T + self.pos
        for i in range(self.dims["n_audio_layer"]):
            b = f"encoder.blocks.{i}"
            h = self._ln(x, b + ".attn_ln")
            x = x + self._attention(h, h, b + ".attn", self.dims["n_audio_head"], causal=False)
            x = x + self._mlp(self._ln(x, b + ".mlp_ln"), b)
        return self._ln(x, "encoder.ln_post")

    def logits(self, tokens: Sequence[int], features: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: (len(tokens), n_vocab) logits."""
        ids = torch.tensor(list(tokens), device=self.device)
        x = self.w["decoder.token_embedding.weight"][ids] + self.w["decoder.positional_embedding"][: len(ids)]
        for i in range(self.dims["n_text_layer"]):
            b = f"decoder.blocks.{i}"
            h = self._ln(x, b + ".attn_ln")
            x = x + self._attention(h, h, b + ".attn", self.dims["n_text_head"], causal=True)
            x = x + self._attention(self._ln(x, b + ".cross_attn_ln"), features, b + ".cross_attn",
                                    self.dims["n_text_head"], causal=False)
            x = x + self._mlp(self._ln(x, b + ".mlp_ln"), b)
        return self.q(self._ln(x, "decoder.ln")) @ self.w["decoder.token_embedding.weight"].T


def filtered_logprobs(logits: torch.Tensor, forced: Sequence[int], vocab: Dict) -> Dict[str, torch.Tensor]:
    """Greedy timestamped decoding's filters (SuppressBlank, SuppressTokens,
    ApplyTimestampRules of whisper/decoding.py) at each step s of a forced
    sequence, logits (F, V) being the logits that choose forced[s].

    Returns the log-probability of each forced token under the filtered
    distribution, and each step's margin of the timestamp-probability rule
    (the best text log-probability less the timestamps' total; the rule
    suppresses text where it is negative)."""
    F_, V = logits.shape
    tsb, eot = vocab["timestamp_begin"], vocab["eot"]
    dev = logits.device
    ids = torch.arange(V, device=dev)
    is_ts = ids >= tsb
    mask = torch.zeros((F_, V), dtype=torch.bool, device=dev)
    mask[:, vocab["suppress"]] = True
    mask[:, vocab["no_timestamps"]] = True
    mask[0, vocab["blank"]] = True
    mask[0, eot] = True
    for s in range(F_):
        seq = list(forced[:s])
        last_ts = len(seq) >= 1 and seq[-1] >= tsb
        penult_ts = len(seq) < 2 or seq[-2] >= tsb
        if last_ts:
            if penult_ts:
                mask[s, tsb:] = True
            else:
                mask[s, :eot] = True
        stamps = [t for t in seq if t >= tsb]
        if stamps:
            floor = stamps[-1] if (last_ts and not penult_ts) else stamps[-1] + 1
            mask[s, tsb:floor] = True
        if s == 0:
            mask[s, :tsb] = True
            mask[s, tsb + MAX_INITIAL_TIMESTAMP_INDEX + 1 :] = True
    x = logits.masked_fill(mask, float("-inf"))
    lp = torch.log_softmax(x, dim=-1)
    ts_total = torch.logsumexp(lp.masked_fill(~is_ts, float("-inf")), dim=-1)
    best_text = lp.masked_fill(is_ts, float("-inf")).amax(dim=-1)
    margin = best_text - ts_total
    x = x.masked_fill((margin < 0)[:, None] & ~is_ts, float("-inf"))
    lp = torch.log_softmax(x, dim=-1)
    chosen = lp.gather(1, torch.tensor(list(forced), device=dev)[:, None])[:, 0]
    return {"logprobs": chosen, "margin": margin}


def window_plan(n_samples: int, forced: Sequence[int], vocab: Dict) -> List[Dict]:
    """The windows whisper's transcribe decodes for a file of n_samples
    when every window yields the forced sequence (a first timestamp, text,
    one closing timestamp, EOT): each window moves the seek by its whole
    size, and conditions on every earlier window's tokens."""
    content = (n_samples + N_SAMPLES) // HOP_LENGTH - N_FRAMES
    tokens = list(forced[:-1])
    tsb = vocab["timestamp_begin"]
    plan, seek, history = [], 0, []
    while seek < content:
        size = min(N_FRAMES, content - seek)
        prompt = history[-PROMPT_MAX:]
        sot = [vocab["sot"], vocab["language"], vocab["transcribe"]]
        initial = ([vocab["sot_prev"]] + prompt if prompt else []) + sot
        offset = seek * HOP_LENGTH / SAMPLE_RATE
        plan.append(dict(seek=seek, size=size, initial=initial, sot_index=len(initial) - 3,
                         start=offset + (tokens[0] - tsb) * TIME_PRECISION,
                         end=offset + (tokens[-1] - tsb) * TIME_PRECISION, tokens=tokens))
        history = history + tokens
        seek += size
    return plan


def judge_file(model: Model, wave: np.ndarray, forced: Sequence[int], vocab: Dict) -> List[Dict]:
    """What the reference expects of each window of one file: its seek,
    segment times and tokens, the average log-probability of its forced
    tokens, log P(no speech) at its SOT, and the rule's smallest margin."""
    mel = log_mel(wave, model.dims["n_mels"], model.device)
    out = []
    for w in window_plan(len(wave), forced, vocab):
        window = F.pad(mel[:, w["seek"] : w["seek"] + w["size"]], (0, N_FRAMES - w["size"]))
        features = model.encode(window)
        seq = w["initial"] + list(forced[:-1])
        logits = model.logits(seq, features)
        n0 = len(w["initial"]) - 1
        steps = filtered_logprobs(logits[n0 : n0 + len(forced)], forced, vocab)
        no_speech = torch.log_softmax(logits[w["sot_index"]], dim=-1)[vocab["no_speech"]]
        out.append(dict(seek=w["seek"], start=w["start"], end=w["end"], tokens=w["tokens"],
                        avg_logprob=float(steps["logprobs"].sum()) / len(forced),
                        no_speech_logprob=float(no_speech),
                        min_margin=float(steps["margin"][steps["margin"].isfinite()].min())))
    return out
