"""Prompt processing: view-dependent text embeddings with a disk cache.

Port of humangaussian_tpu/guidance/prompt.py:

- four directions (side / front / back / overhead) chosen per camera by
  azimuth and elevation thresholds (defaults 45 / 45 / 60 degrees); later
  directions override earlier ones, so "side" is the catch-all;
- the embeddings are computed once on the host by an `encode_fn`
  (`list[str] -> [n, L, D]` numpy) and cached on disk as `.npy` files keyed
  by the md5 of model path and prompt;
- `get_text_embeddings` returns the 3-segment `[cond | neg | null]` batch
  the ANPG guidance expects;
- "lib:" prompts resolve through a JSON prompt library.

The direction selection is torch code on the cameras' device. Encoding is
host-side set-up. Without an `encode_fn` the processor encodes with
`hf_clip_encode_fn(model_path)` (a `transformers` CLIP text model on the
host CPU, as the JAX package runs it), built only when a prompt misses the
cache: a run whose prompts are all cached needs no `transformers`. When
one is missing and `transformers` is not installed, the error names the
prompts and the cache directory. The T5 encoder, Perp-Neg and prompt
debiasing are not ported (ROADMAP item 19). `dummy_encode_fn` gives
deterministic pseudo-embeddings for pipelines that need the plumbing
without a text encoder.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch


def shift_azimuth_deg(azimuth):
    """Map azimuth degrees into [-180, 180)."""
    return (azimuth + 180.0) % 360.0 - 180.0


@dataclasses.dataclass(frozen=True)
class DirectionConfig:
    name: str
    prompt: Callable[[str], str]
    negative_prompt: Callable[[str], str]


def directions(front_style: bool = False) -> Sequence[DirectionConfig]:
    """The four view-dependent prompt decorations."""
    if front_style:  # "side view of {s}"
        fmt = lambda d: (lambda s, d=d: f"{d} view of {s}")
    else:  # "{s}, side view"
        fmt = lambda d: (lambda s, d=d: f"{s}, {d} view")
    return (
        DirectionConfig("side", fmt("side"), lambda s: s),
        DirectionConfig("front", fmt("front"), lambda s: s),
        DirectionConfig(
            "back", fmt("backside" if front_style else "back"), lambda s: s
        ),
        DirectionConfig("overhead", fmt("overhead"), lambda s: s),
    )


def direction_index(
    elevation,
    azimuth,
    overhead_threshold: float = 60.0,
    front_threshold: float = 45.0,
    back_threshold: float = 45.0,
):
    """[B] direction ids (0 side, 1 front, 2 back, 3 overhead) from
    elevation and azimuth tensors in degrees; later conditions override
    earlier ones."""
    az = shift_azimuth_deg(azimuth)
    idx = torch.zeros(elevation.shape, dtype=torch.int64,
                      device=elevation.device)  # side everywhere
    idx = torch.where((az > -front_threshold) & (az < front_threshold), 1, idx)
    idx = torch.where(
        (az > 180.0 - back_threshold) | (az < -180.0 + back_threshold), 2, idx
    )
    return torch.where(elevation > overhead_threshold, 3, idx)


class PromptEmbeddings(NamedTuple):
    """Precomputed embeddings, float32 tensors on one device."""

    text_vd: torch.Tensor  # [4, L, D] view-dependent cond
    uncond_vd: torch.Tensor  # [4, L, D] view-dependent negative
    text: torch.Tensor  # [L, D] plain cond
    uncond: torch.Tensor  # [L, D] plain negative
    null: torch.Tensor  # [L, D] empty prompt

    def get_text_embeddings(
        self, elevation, azimuth, camera_distances=None,
        view_dependent_prompting: bool = True, **thresholds
    ):
        """[3B, L, D] in [cond | neg | null] order."""
        b = elevation.shape[0]
        if view_dependent_prompting:
            idx = direction_index(elevation, azimuth, **thresholds)
            cond = self.text_vd[idx]
            neg = self.uncond_vd[idx]
        else:
            cond = self.text.expand(b, *self.text.shape)
            neg = self.uncond.expand(b, *self.uncond.shape)
        null = self.null.expand(b, *self.null.shape)
        return torch.cat([cond, neg, null], dim=0)


@dataclasses.dataclass
class PromptProcessorConfig:
    prompt: str = ""
    negative_prompt: str = ""
    model_path: str = ""  # keys the cache (and names the text encoder)
    overhead_threshold: float = 60.0
    front_threshold: float = 45.0
    back_threshold: float = 45.0
    view_dependent_prompt_front: bool = False
    cache_dir: str = ".humangaussian_cache/text_embeddings"
    prompt_library_path: str = ""  # JSON for "lib:" prompts
    use_cache: bool = True


def _hash_prompt(model: str, prompt: str) -> str:
    return hashlib.md5(f"{model}-{prompt}".encode()).hexdigest()


def resolve_library_prompt(prompt: str, library_path: str) -> str:
    """'lib:keyword1_keyword2' -> the first library prompt that contains
    every keyword; an error when none does."""
    if not prompt.startswith("lib:"):
        return prompt
    with open(library_path) as f:
        library = json.load(f)
    keywords = prompt[4:].lower().split("_")
    candidates = [
        p
        for group in library.values()
        for p in group
        if all(k in p.lower() for k in keywords)
    ]
    if not candidates:
        raise ValueError(f"no library prompt matches {prompt!r}")
    return candidates[0]


def hf_clip_encode_fn(model_path: str) -> Callable[[list[str]], np.ndarray]:
    """A host CLIP text encoder from a local checkpoint (`tokenizer/` and
    `text_encoder/` subfolders, or one flat directory): prompts -> [n, L, D]
    float32 numpy, L the text model's position count. `transformers` is
    imported when it encodes."""

    def encode(prompts: list[str]) -> np.ndarray:
        from transformers import AutoTokenizer, CLIPTextModel

        tok_path = os.path.join(model_path, "tokenizer")
        enc_path = os.path.join(model_path, "text_encoder")
        tokenizer = AutoTokenizer.from_pretrained(
            tok_path if os.path.isdir(tok_path) else model_path)
        encoder = CLIPTextModel.from_pretrained(
            enc_path if os.path.isdir(enc_path) else model_path)
        encoder.eval()
        # without a tokenizer_config the tokenizer's model_max_length is a
        # ~1e30 sentinel; the text model's position count is the limit
        max_len = min(int(tokenizer.model_max_length),
                      int(encoder.config.max_position_embeddings))
        with torch.no_grad():
            tokens = tokenizer(prompts, padding="max_length",
                               max_length=max_len, truncation=True,
                               return_tensors="pt")
            out = encoder(tokens.input_ids)[0]
        return out.float().numpy()

    return encode


class PromptProcessor:
    """Host-side precompute; calling it gives a `PromptEmbeddings` on
    `device`. Without `encode_fn`, prompts missing from the cache are
    encoded by `hf_clip_encode_fn(cfg.model_path)`."""

    def __init__(
        self,
        cfg: PromptProcessorConfig,
        encode_fn: Callable[[list[str]], np.ndarray] | None = None,
        device="cuda",
    ):
        from humangaussian_torch import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.encode_fn = encode_fn
        prompt = cfg.prompt
        if prompt.startswith("lib:"):
            prompt = resolve_library_prompt(prompt, cfg.prompt_library_path)
        self.prompt = prompt
        self.negative_prompt = cfg.negative_prompt
        self.directions = directions(cfg.view_dependent_prompt_front)

    def _cache_path(self, prompt: str) -> str:
        return os.path.join(
            self.cfg.cache_dir,
            _hash_prompt(self.cfg.model_path, prompt) + ".npy")

    def _encode(self, prompts: list[str]) -> np.ndarray:
        """Encode prompts the cache lacks, building the CLIP encoder on
        first need."""
        if self.encode_fn is None:
            try:
                import transformers  # noqa: F401
            except ImportError as exc:
                raise ImportError(
                    f"prompts {prompts!r} are not in the embedding cache "
                    f"{os.path.abspath(self.cfg.cache_dir)!r}, and encoding "
                    "them needs the `transformers` package, which is not "
                    "installed; fill the cache where it is (or pass an "
                    "encode_fn)") from exc
            self.encode_fn = hf_clip_encode_fn(self.cfg.model_path)
        return np.asarray(self.encode_fn(prompts))

    def _encode_cached(self, prompts: list[str]) -> np.ndarray:
        if not self.cfg.use_cache:
            return self._encode(prompts)
        os.makedirs(self.cfg.cache_dir, exist_ok=True)
        out: dict[int, np.ndarray] = {}
        missing = []
        for i, p in enumerate(prompts):
            if os.path.exists(self._cache_path(p)):
                out[i] = np.load(self._cache_path(p))
            else:
                missing.append((i, p))
        if missing:
            fresh = self._encode([p for _, p in missing])
            for (i, p), emb in zip(missing, fresh):
                np.save(self._cache_path(p), emb)
                out[i] = emb
        return np.stack([out[i] for i in range(len(prompts))])

    def __call__(self) -> PromptEmbeddings:
        vd_prompts = [d.prompt(self.prompt) for d in self.directions]
        vd_neg = [d.negative_prompt(self.negative_prompt)
                  for d in self.directions]
        emb = self._encode_cached(
            [self.prompt, self.negative_prompt, ""] + vd_prompts + vd_neg)
        n = len(self.directions)

        def t(x):
            return torch.from_numpy(
                np.ascontiguousarray(x, np.float32)).to(self.device)

        return PromptEmbeddings(
            text=t(emb[0]),
            uncond=t(emb[1]),
            null=t(emb[2]),
            text_vd=t(emb[3: 3 + n]),
            uncond_vd=t(emb[3 + n: 3 + 2 * n]),
        )


def dummy_encode_fn(
    seq_len: int = 77, dim: int = 1024
) -> Callable[[list[str]], np.ndarray]:
    """Deterministic pseudo-embeddings keyed by the prompt's hash, for
    pipelines and tests that need the PromptEmbeddings plumbing without a
    text-encoder checkpoint."""

    def encode(prompts: list[str]) -> np.ndarray:
        out = []
        for p in prompts:
            seed = int(_hash_prompt("dummy", p)[:8], 16)
            rs = np.random.RandomState(seed)
            out.append(rs.normal(0, 1, (seq_len, dim)).astype(np.float32))
        return np.stack(out)

    return encode
