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
- "lib:" prompts resolve through a JSON prompt library;
- `get_text_embeddings_perp_neg` builds Perp-Neg's 4-segment batch
  (positive prompt interpolated between front, side and back by azimuth,
  two negative-direction prompts a camera with signed decay weights).

The direction selection is torch code on the cameras' device. Encoding is
host-side set-up. Without an `encode_fn` the processor encodes with
`hf_clip_encode_fn(model_path)` (`encoder_type: clip`, the SD2 prior) or
`hf_t5_encode_fn(model_path)` (`t5`, DeepFloyd IF) or
`hf_sdxl_encode_fn(model_path)` (`sdxl`: SDXL's two CLIP encoders, whose
token rows are concatenated and whose second gives the pooled row that
`PromptEmbeddings.pooled` carries): a `transformers` text model on the
host CPU, as the JAX package runs it, built only when a
prompt misses the cache: a run whose prompts are all cached needs no
`transformers`. When one is missing and `transformers` is not installed,
the error names the prompts and the cache directory.
`use_prompt_debiasing` rewrites the view-dependent prompts with a BERT
masked language model (`get_debiased_prompts`), which needs
`transformers` whatever the cache holds. `dummy_encode_fn` gives
deterministic pseudo-embeddings for pipelines that need the plumbing
without a text encoder; `DummyPromptProcessor` is a processor wired to it.
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
    # SDXL: the pooled text rows, the same five fields [4, P] / [P], whose
    # `get_text_embeddings` picks [3B, P] rows as the token rows are picked
    pooled: "PromptEmbeddings | None" = None

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


def shifted_exponential_decay(a, b, c, r):
    """a exp(-b r) + c."""
    return a * torch.exp(-b * r) + c


def perpendicular_component(x, y):
    """The component of x perpendicular to y, batched over axis 0."""
    axes = tuple(range(1, x.dim()))
    dot = (x * y).sum(dim=axes, keepdim=True)
    nrm = (y * y).sum(dim=axes, keepdim=True)
    return x - dot / nrm.clamp_min(1e-6) * y


# default Perp-Neg decay coefficients (a, b, c)
PERP_NEG_F_SB = (1.0, 0.5, -0.606)
PERP_NEG_F_FSB = (1.0, 0.5, 0.967)
PERP_NEG_F_FS = (4.0, 0.5, -2.426)
PERP_NEG_F_SF = (4.0, 0.5, -2.426)


def get_text_embeddings_perp_neg(
    emb: PromptEmbeddings,
    elevation,
    azimuth,
    camera_distances=None,
    f_sb=PERP_NEG_F_SB,
    f_fsb=PERP_NEG_F_FSB,
    f_fs=PERP_NEG_F_FS,
    f_sf=PERP_NEG_F_SF,
    **thresholds,
):
    """Perp-Neg embeddings: ([4B, L, D] in [pos | uncond | neg1, neg2
    interleaved per camera] order, weights [B, 2]). The positive prompt
    interpolates front -> side (|azimuth| < 90) or side -> back by
    azimuth; overhead views take the overhead prompt and zero weights."""
    az = shift_azimuth_deg(azimuth)
    idx = direction_index(elevation, azimuth, **thresholds)
    side, front, back, overhead = emb.text_vd.unbind(0)
    uncond = emb.uncond_vd[idx]  # [B, L, D]

    abs_az = az.abs()
    is_over = (idx == 3)[:, None, None]
    is_fs = (abs_az < 90.0)[:, None, None]
    r_fs = 1.0 - abs_az / 90.0  # 1 front, 0 side
    r_sb = 2.0 - abs_az / 90.0  # 1 side, 0 back

    pos_fs = r_fs[:, None, None] * front + (1 - r_fs)[:, None, None] * side
    pos_sb = r_sb[:, None, None] * side + (1 - r_sb)[:, None, None] * back
    pos = torch.where(is_over, overhead, torch.where(is_fs, pos_fs, pos_sb))

    b = az.shape[0]
    bfront = front.expand(b, *front.shape)
    bside = side.expand(b, *side.shape)
    neg1 = torch.where(is_over, uncond, torch.where(is_fs, bfront, bside))
    neg2 = torch.where(is_over, uncond, torch.where(is_fs, bside, bfront))

    zero = torch.zeros_like(r_fs)
    w1 = torch.where(idx == 3, zero, torch.where(
        abs_az < 90.0, -shifted_exponential_decay(*f_fs, r_fs),
        -shifted_exponential_decay(*f_sb, r_sb)))
    w2 = torch.where(idx == 3, zero, torch.where(
        abs_az < 90.0, -shifted_exponential_decay(*f_sf, 1.0 - r_fs),
        -shifted_exponential_decay(*f_fsb, r_sb)))
    negs = torch.stack([neg1, neg2], dim=1).reshape(2 * b, *neg1.shape[1:])
    return (torch.cat([pos, uncond, negs], dim=0),
            torch.stack([w1, w2], dim=1))


@dataclasses.dataclass
class PromptProcessorConfig:
    prompt: str = ""
    negative_prompt: str = ""
    model_path: str = ""  # keys the cache (and names the text encoder)
    overhead_threshold: float = 60.0
    front_threshold: float = 45.0
    back_threshold: float = 45.0
    view_dependent_prompt_front: bool = False
    use_prompt_debiasing: bool = False
    prompt_debiasing_model_path: str = "bert-base-uncased"
    prompt_debiasing_mask_ids: tuple | None = None
    cache_dir: str = ".humangaussian_cache/text_embeddings"
    prompt_library_path: str = ""  # JSON for "lib:" prompts
    use_cache: bool = True
    encoder_type: str = "clip"  # "clip" (SD2) | "t5" (DeepFloyd IF) | "sdxl"


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


def _transformers(what: str):
    """The `transformers` module, or an ImportError naming `what` needs
    it."""
    try:
        import transformers
    except ImportError as exc:
        raise ImportError(
            f"{what} needs the `transformers` package, which is not "
            "installed") from exc
    return transformers


def _checkpoint_parts(model_path: str):
    """(tokenizer dir, text encoder dir): the `tokenizer/` and
    `text_encoder/` subfolders, or the flat directory itself."""
    tok = os.path.join(model_path, "tokenizer")
    enc = os.path.join(model_path, "text_encoder")
    return (tok if os.path.isdir(tok) else model_path,
            enc if os.path.isdir(enc) else model_path)


def get_debiased_prompts(prompt: str, view_names: list[str],
                         model_path: str,
                         mask_ids: list[int] | None = None) -> list[str]:
    """BERT masked-LM prompt debiasing: for each word (or the words of
    `mask_ids`), compare the view-word distribution of "This image is
    depicting a [MASK] view of <prompt>" with and without the word; a word
    whose pointwise mutual information with a view falls below 0.95 is
    dropped from that view's prompt. Host-side torch, like the encoders."""
    import torch.nn.functional as F

    tf = _transformers("prompt debiasing")
    os.environ["TOKENIZERS_PARALLELISM"] = "false"
    tokenizer = tf.AutoTokenizer.from_pretrained(model_path)
    model = tf.BertForMaskedLM.from_pretrained(model_path)
    model.eval()

    view_ids = tokenizer(" ".join(view_names),
                         return_tensors="pt").input_ids[0]
    view_ids = view_ids[1: 1 + len(view_names)]

    @torch.no_grad()
    def modulate(p: str) -> torch.Tensor:
        tokens = tokenizer(f"This image is depicting a [MASK] view of {p}",
                           padding="max_length", truncation=True,
                           add_special_tokens=True, return_tensors="pt")
        mask_idx = torch.where(tokens.input_ids == tokenizer.mask_token_id)[1]
        logits = model(**tokens).logits
        probs = F.softmax(logits[0, mask_idx], dim=-1)[0, view_ids]
        return probs / probs.sum()

    words = prompt.split(" ")
    prompts = [list(words) for _ in view_names]
    full_probe = modulate(prompt)
    ids = mask_ids if mask_ids is not None else list(range(len(words)))
    for idx in ids:
        part_probe = modulate(" ".join(words[:idx] + words[idx + 1:]))
        pmi = full_probe / torch.lerp(part_probe, full_probe, 0.5)
        for i in range(pmi.shape[0]):
            if pmi[i].item() < 0.95:
                prompts[i][idx] = ""
    return [" ".join(w for w in p if w) for p in prompts]


def hf_t5_encode_fn(model_path: str) -> Callable[[list[str]], np.ndarray]:
    """A host T5 text encoder from a local checkpoint (DeepFloyd IF's
    prompt pipeline: attention-masked encode at 77 tokens at most),
    laid out as `hf_clip_encode_fn` takes it: prompts -> [n, L, D] float32
    numpy. `transformers` is imported when it encodes."""

    def encode(prompts: list[str]) -> np.ndarray:
        tf = _transformers("the T5 prompt encoder")
        tok_path, enc_path = _checkpoint_parts(model_path)
        tokenizer = tf.AutoTokenizer.from_pretrained(tok_path)
        encoder = tf.T5EncoderModel.from_pretrained(enc_path)
        encoder.eval()
        max_len = min(int(tokenizer.model_max_length), 77)
        with torch.no_grad():
            tokens = tokenizer(prompts, padding="max_length",
                               max_length=max_len, truncation=True,
                               add_special_tokens=True, return_tensors="pt")
            out = encoder(tokens.input_ids,
                          attention_mask=tokens.attention_mask)[0]
        return out.float().numpy()

    return encode


def hf_clip_encode_fn(model_path: str) -> Callable[[list[str]], np.ndarray]:
    """A host CLIP text encoder from a local checkpoint (`tokenizer/` and
    `text_encoder/` subfolders, or one flat directory): prompts -> [n, L, D]
    float32 numpy, L the text model's position count. `transformers` is
    imported when it encodes."""

    def encode(prompts: list[str]) -> np.ndarray:
        tf = _transformers("the CLIP prompt encoder")
        tok_path, enc_path = _checkpoint_parts(model_path)
        tokenizer = tf.AutoTokenizer.from_pretrained(tok_path)
        encoder = tf.CLIPTextModel.from_pretrained(enc_path)
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


def hf_sdxl_encode_fn(model_path: str):
    """SDXL's host text encoders from a local checkpoint (`tokenizer/`,
    `text_encoder/`: CLIP ViT-L; `tokenizer_2/`, `text_encoder_2/`:
    OpenCLIP bigG with its projection): prompts -> ([n, 77, 768 + 1280]
    float32, the penultimate hidden states of both, concatenated; [n,
    1280], the second encoder's projected pooled output), as the SDXL
    pipeline builds them. `transformers` is imported when it encodes."""

    def encode(prompts: list[str]):
        tf = _transformers("the SDXL prompt encoders")
        rows, pooled = [], None
        for sub, cls in (("", tf.CLIPTextModel),
                         ("_2", tf.CLIPTextModelWithProjection)):
            tokenizer = tf.AutoTokenizer.from_pretrained(
                os.path.join(model_path, "tokenizer" + sub))
            encoder = cls.from_pretrained(
                os.path.join(model_path, "text_encoder" + sub))
            encoder.eval()
            with torch.no_grad():
                tokens = tokenizer(prompts, padding="max_length",
                                   max_length=tokenizer.model_max_length,
                                   truncation=True, return_tensors="pt")
                out = encoder(tokens.input_ids, output_hidden_states=True)
            rows.append(out.hidden_states[-2].float())
            if sub:
                pooled = out[0].float()
        return (torch.cat(rows, dim=-1).numpy(), pooled.numpy())

    return encode


class PromptProcessor:
    """Host-side precompute; calling it gives a `PromptEmbeddings` on
    `device`. Without `encode_fn`, prompts missing from the cache are
    encoded by the `cfg.encoder_type` encoder of `cfg.model_path`."""

    def __init__(
        self,
        cfg: PromptProcessorConfig,
        encode_fn: Callable[[list[str]], np.ndarray] | None = None,
        device="cuda",
    ):
        from humangaussian_torch import resolve_device

        if cfg.encoder_type not in ("clip", "t5", "sdxl"):
            raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}; "
                             "expected 'clip', 't5' or 'sdxl'")
        self.with_pooled = cfg.encoder_type == "sdxl"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encode_fn = encode_fn
        prompt = cfg.prompt
        if prompt.startswith("lib:"):
            prompt = resolve_library_prompt(prompt, cfg.prompt_library_path)
        self.prompt = prompt
        self.negative_prompt = cfg.negative_prompt
        self.directions = directions(cfg.view_dependent_prompt_front)

    def _cache_path(self, prompt: str, suffix: str = "") -> str:
        return os.path.join(
            self.cfg.cache_dir,
            _hash_prompt(self.cfg.model_path, prompt) + suffix + ".npy")

    def _encode(self, prompts: list[str]):
        """Encode prompts the cache lacks, building the text encoder on
        first need: ([n, L, D], [n, P] pooled rows or None)."""
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
            build = {"t5": hf_t5_encode_fn, "sdxl": hf_sdxl_encode_fn}.get(
                self.cfg.encoder_type, hf_clip_encode_fn)
            self.encode_fn = build(self.cfg.model_path)
        out = self.encode_fn(prompts)
        if self.with_pooled != isinstance(out, tuple):
            raise ValueError(
                f"encoder_type {self.cfg.encoder_type!r} "
                + ("needs" if self.with_pooled else "takes no")
                + " pooled rows from the encode function")
        if self.with_pooled:
            return np.asarray(out[0]), np.asarray(out[1])
        return np.asarray(out), None

    def _encode_cached(self, prompts: list[str]):
        """([n, L, D], [n, P] or None) through the cache: the pooled rows
        of a prompt are a second file beside its token rows."""
        if not self.cfg.use_cache:
            return self._encode(prompts)
        os.makedirs(self.cfg.cache_dir, exist_ok=True)
        suffixes = ("", ".pooled") if self.with_pooled else ("",)
        out: dict[int, tuple] = {}
        missing = []
        for i, p in enumerate(prompts):
            paths = [self._cache_path(p, x) for x in suffixes]
            if all(os.path.exists(f) for f in paths):
                out[i] = tuple(np.load(f) for f in paths)
            else:
                missing.append((i, p))
        if missing:
            fresh = self._encode([p for _, p in missing])
            for j, (i, p) in enumerate(missing):
                out[i] = tuple(x[j] for x in fresh if x is not None)
                for x, arr in zip(suffixes, out[i]):
                    np.save(self._cache_path(p, x), arr)
        stacked = [np.stack([out[i][k] for i in range(len(prompts))])
                   for k in range(len(suffixes))]
        return stacked[0], stacked[1] if self.with_pooled else None

    def __call__(self) -> PromptEmbeddings:
        cfg = self.cfg
        if cfg.use_prompt_debiasing:
            debiased = get_debiased_prompts(
                self.prompt, [d.name for d in self.directions],
                cfg.prompt_debiasing_model_path,
                None if cfg.prompt_debiasing_mask_ids is None
                else list(cfg.prompt_debiasing_mask_ids))
            vd_prompts = [d.prompt(p)
                          for d, p in zip(self.directions, debiased)]
        else:
            vd_prompts = [d.prompt(self.prompt) for d in self.directions]
        vd_neg = [d.negative_prompt(self.negative_prompt)
                  for d in self.directions]
        emb, pooled = self._encode_cached(
            [self.prompt, self.negative_prompt, ""] + vd_prompts + vd_neg)
        n = len(self.directions)

        def t(x):
            return torch.from_numpy(
                np.ascontiguousarray(x, np.float32)).to(self.device)

        def fields(e):
            return dict(text=t(e[0]), uncond=t(e[1]), null=t(e[2]),
                        text_vd=t(e[3: 3 + n]),
                        uncond_vd=t(e[3 + n: 3 + 2 * n]))

        return PromptEmbeddings(
            **fields(emb),
            pooled=None if pooled is None
            else PromptEmbeddings(**fields(pooled)))


def dummy_encode_fn(
    seq_len: int = 77, dim: int = 1024, pooled_dim: int = 0
) -> Callable[[list[str]], np.ndarray]:
    """Deterministic pseudo-embeddings keyed by the prompt's hash, for
    pipelines and tests that need the PromptEmbeddings plumbing without a
    text-encoder checkpoint; with `pooled_dim`, also [n, pooled_dim]
    pooled rows (the `sdxl` encoder type's pair)."""

    def encode(prompts: list[str]):
        out, pooled = [], []
        for p in prompts:
            seed = int(_hash_prompt("dummy", p)[:8], 16)
            rs = np.random.RandomState(seed)
            out.append(rs.normal(0, 1, (seq_len, dim)).astype(np.float32))
            if pooled_dim:
                pooled.append(rs.normal(0, 1, pooled_dim).astype(np.float32))
        if pooled_dim:
            return np.stack(out), np.stack(pooled)
        return np.stack(out)

    return encode


class DummyPromptProcessor(PromptProcessor):
    """A PromptProcessor wired to `dummy_encode_fn()` unless given
    another encoder."""

    def __init__(self, cfg: PromptProcessorConfig, encode_fn=None,
                 device="cuda"):
        super().__init__(cfg, encode_fn or dummy_encode_fn(), device)
