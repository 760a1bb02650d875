"""guidance/prompt.py of the port against the JAX package: the direction
index and the [cond | neg | null] batch exactly over a grid of angles, the
dummy encoder, the md5 cache round trip."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.convert import prompt_embeddings_from_numpy
from humangaussian_torch.guidance import prompt as port
from humangaussian_tpu.guidance import prompt as ref

torch.set_num_threads(1)


def _angle_grid():
    az = np.arange(-360.0, 721.0, 7.5, dtype=np.float32)
    el = np.array([-30.0, 0.0, 59.0, 60.0, 60.5, 89.0], np.float32)
    azg, elg = np.meshgrid(az, el)
    return elg.reshape(-1), azg.reshape(-1)


@pytest.mark.parametrize("thresholds", [
    {}, {"overhead_threshold": 30.0, "front_threshold": 60.0,
         "back_threshold": 20.0}])
def test_direction_index_matches_over_a_grid(thresholds):
    el, az = _angle_grid()
    want = np.asarray(ref.direction_index(jnp.asarray(el), jnp.asarray(az),
                                          **thresholds))
    got = port.direction_index(torch.from_numpy(el), torch.from_numpy(az),
                               **thresholds)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(
        port.shift_azimuth_deg(torch.from_numpy(az)).numpy(),
        np.asarray(ref.shift_azimuth_deg(jnp.asarray(az))))


@pytest.mark.parametrize("front_style", [False, True])
def test_direction_prompts_match(front_style):
    for a, b in zip(port.directions(front_style), ref.directions(front_style)):
        assert a.name == b.name
        assert a.prompt("a man") == b.prompt("a man")
        assert a.negative_prompt("ugly") == b.negative_prompt("ugly")


def _processors(tmp_path, **kw):
    enc = port.dummy_encode_fn(5, 8)
    pcfg = port.PromptProcessorConfig(
        prompt="a man in a suit", negative_prompt="blurry",
        cache_dir=str(tmp_path / "port"), **kw)
    rcfg = ref.PromptProcessorConfig(
        prompt="a man in a suit", negative_prompt="blurry",
        cache_dir=str(tmp_path / "ref"), **kw)
    return (port.PromptProcessor(pcfg, enc, device="cpu"),
            ref.PromptProcessor(rcfg, ref.dummy_encode_fn(5, 8)))


@pytest.mark.parametrize("view_dependent", [True, False])
def test_text_embeddings_match_exactly(tmp_path, view_dependent):
    pp, rp = _processors(tmp_path)
    pe, re_ = pp(), rp()
    for name in ref.PromptEmbeddings._fields:
        np.testing.assert_array_equal(getattr(pe, name).numpy(),
                                      np.asarray(getattr(re_, name)))
    el, az = _angle_grid()
    want = np.asarray(re_.get_text_embeddings(
        jnp.asarray(el), jnp.asarray(az),
        view_dependent_prompting=view_dependent))
    got = pe.get_text_embeddings(
        torch.from_numpy(el), torch.from_numpy(az),
        view_dependent_prompting=view_dependent)
    assert got.shape == (3 * el.shape[0], 5, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the last third is the null prompt, whatever the view
    np.testing.assert_array_equal(got[-1].numpy(), pe.null.numpy())


def test_dummy_encoder_matches():
    prompts = ["", "a man", "a man, back view"]
    np.testing.assert_array_equal(port.dummy_encode_fn(7, 16)(prompts),
                                  ref.dummy_encode_fn(7, 16)(prompts))


def test_cache_round_trip(tmp_path):
    """The first call encodes and writes one .npy per distinct prompt under
    the md5 of model path and prompt; the second call reads them back and
    does not encode."""
    calls = []
    enc = port.dummy_encode_fn(5, 8)

    def counting(prompts):
        calls.append(list(prompts))
        return enc(prompts)

    cfg = port.PromptProcessorConfig(
        prompt="a man", negative_prompt="blurry", model_path="some/model",
        cache_dir=str(tmp_path))
    first = port.PromptProcessor(cfg, counting, device="cpu")()
    assert len(calls) == 1 and len(calls[0]) == 11
    names = set(os.listdir(tmp_path))
    key = port._hash_prompt("some/model", "a man, back view")
    assert key + ".npy" in names
    assert key == ref._hash_prompt("some/model", "a man, back view")
    assert len(names) == 7  # prompt, negative, "", four directions
    second = port.PromptProcessor(cfg, counting, device="cpu")()
    assert len(calls) == 1
    assert first.pooled is None and second.pooled is None
    for a, b in zip(first[:5], second[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    uncached = port.PromptProcessor(
        port.PromptProcessorConfig(prompt="a man", negative_prompt="blurry",
                                   use_cache=False), counting, device="cpu")()
    assert len(calls) == 2
    np.testing.assert_array_equal(uncached.text.numpy(), first.text.numpy())


def test_processor_without_an_encoder_says_what_is_missing(tmp_path,
                                                          monkeypatch):
    """Without an encode_fn the CLIP encoder is built only on a cache miss;
    without `transformers` that miss raises an error naming the prompts and
    the cache directory, and a filled cache needs no encoder at all."""
    cfg = port.PromptProcessorConfig(prompt="a man", model_path="m",
                                     cache_dir=str(tmp_path / "cache"))
    monkeypatch.setitem(sys.modules, "transformers", None)
    proc = port.PromptProcessor(cfg, device="cpu")
    with pytest.raises(ImportError, match="transformers") as err:
        proc()
    assert "a man" in str(err.value) and str(tmp_path / "cache") in str(
        err.value)
    filled = port.PromptProcessor(cfg, port.dummy_encode_fn(3, 4),
                                  device="cpu")()
    again = port.PromptProcessor(cfg, device="cpu")()
    np.testing.assert_array_equal(again.text_vd.numpy(),
                                  filled.text_vd.numpy())


def test_library_prompt(tmp_path):
    lib = tmp_path / "lib.json"
    lib.write_text('{"people": ["A tall man in a suit", "a woman"]}')
    assert port.resolve_library_prompt("lib:man_suit", str(lib)) == \
        ref.resolve_library_prompt("lib:man_suit", str(lib))
    with pytest.raises(ValueError):
        port.resolve_library_prompt("lib:robot", str(lib))
    cfg = port.PromptProcessorConfig(prompt="lib:woman", use_cache=False,
                                     prompt_library_path=str(lib))
    assert port.PromptProcessor(cfg, port.dummy_encode_fn(2, 2),
                                device="cpu").prompt == "a woman"


def test_prompt_embeddings_from_numpy(tmp_path):
    _, rp = _processors(tmp_path)
    re_ = rp()
    pe = prompt_embeddings_from_numpy(re_, device="cpu")
    for name in ref.PromptEmbeddings._fields:
        np.testing.assert_array_equal(getattr(pe, name).numpy(),
                                      np.asarray(getattr(re_, name)))


# ---- Perp-Neg, the T5 encoder, debiasing, the dummy processor -------------


def test_perpendicular_component_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(4, 3, 5, 2).astype(np.float32)
    y = rng.randn(4, 3, 5, 2).astype(np.float32)
    y[1] = 0.0  # the 1e-6 floor of |y|^2
    want = np.asarray(ref.perpendicular_component(jnp.asarray(x),
                                                  jnp.asarray(y)))
    got = port.perpendicular_component(torch.from_numpy(x),
                                       torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    r = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    np.testing.assert_allclose(
        port.shifted_exponential_decay(4.0, 0.5, -2.426,
                                       torch.from_numpy(r)).numpy(),
        np.asarray(ref.shifted_exponential_decay(4.0, 0.5, -2.426,
                                                 jnp.asarray(r))),
        atol=1e-6)


def test_perp_neg_embeddings_match(tmp_path):
    """The 4-segment batch and the weights over the angle grid (front,
    side, back and overhead views, azimuths past +-180), within 1e-6."""
    pp, rp = _processors(tmp_path)
    pe, re_ = pp(), rp()
    el, az = _angle_grid()
    want_emb, want_w = ref.get_text_embeddings_perp_neg(
        re_, jnp.asarray(el), jnp.asarray(az))
    got_emb, got_w = port.get_text_embeddings_perp_neg(
        pe, torch.from_numpy(el), torch.from_numpy(az))
    assert got_emb.shape == (4 * el.shape[0], 5, 8)
    assert got_w.shape == (el.shape[0], 2)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)
    assert float(got_w.abs().max()) > 0 and float(got_w.abs().min()) == 0


def test_t5_encoder_and_encoder_type(tmp_path):
    """`hf_t5_encode_fn` of a tiny real T5 checkpoint gives the JAX
    package's embeddings, and `encoder_type: t5` builds it on a cache
    miss; an unknown encoder_type raises."""
    from test_t5_prompt import make_t5_checkpoint

    path = make_t5_checkpoint(str(tmp_path / "t5"))
    prompts = ["a man", "a woman in a dress", ""]
    got = port.hf_t5_encode_fn(path)(prompts)
    want = ref.hf_t5_encode_fn(path)(prompts)
    assert got.shape == (3, 77, 32)
    np.testing.assert_array_equal(got, want)
    cfg = port.PromptProcessorConfig(prompt="a man", model_path=path,
                                     encoder_type="t5",
                                     cache_dir=str(tmp_path / "cache"))
    emb = port.PromptProcessor(cfg, device="cpu")()
    np.testing.assert_array_equal(emb.text.numpy(), want[0])
    with pytest.raises(ValueError, match="encoder_type"):
        port.PromptProcessor(port.PromptProcessorConfig(
            encoder_type="bert"), device="cpu")


def test_t5_encoder_without_transformers_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="T5 prompt encoder.*transformers"):
        port.hf_t5_encode_fn("some/dir")(["a man"])


def _tiny_bert(root):
    """A tiny random BertForMaskedLM and a word-level vocabulary that holds
    the view names and the prompt's words; initialized wide (std 1), so
    that the view-word probabilities move enough for debiasing to drop
    words."""
    from transformers import BertConfig, BertForMaskedLM, BertTokenizer

    words = ["side", "front", "back", "overhead", "this", "image", "is",
             "depicting", "a", "view", "of", "man", "in", "red", "suit"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    os.makedirs(root)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    BertTokenizer(os.path.join(root, "vocab.txt"),
                  model_max_length=32).save_pretrained(root)
    torch.manual_seed(0)
    BertForMaskedLM(BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32,
        initializer_range=1.0)).save_pretrained(root)
    return root


def test_prompt_debiasing_matches(tmp_path):
    """`get_debiased_prompts` with a tiny BERT gives the JAX package's
    prompts (both run the same host torch), and `use_prompt_debiasing`
    encodes the debiased view prompts."""
    bert = _tiny_bert(str(tmp_path / "bert"))
    views = ["side", "front", "back", "overhead"]
    prompt = "a man in red suit"
    got = port.get_debiased_prompts(prompt, views, bert)
    assert got == ref.get_debiased_prompts(prompt, views, bert)
    assert got != [prompt] * 4  # some word was dropped from some view
    assert port.get_debiased_prompts(prompt, views, bert, [1]) == \
        ref.get_debiased_prompts(prompt, views, bert, [1])
    seen = []
    enc = port.dummy_encode_fn(3, 4)
    port.PromptProcessor(
        port.PromptProcessorConfig(
            prompt=prompt, use_prompt_debiasing=True,
            prompt_debiasing_model_path=bert, use_cache=False),
        lambda p: seen.extend(p) or enc(p), device="cpu")()
    assert seen[3:7] == [port.directions()[i].prompt(p)
                         for i, p in enumerate(got)]


def test_dummy_prompt_processor():
    cfg = port.PromptProcessorConfig(prompt="a man", use_cache=False)
    got = port.DummyPromptProcessor(cfg, device="cpu")()
    want = ref.DummyPromptProcessor(ref.PromptProcessorConfig(
        prompt="a man", use_cache=False))()
    assert got.text_vd.shape == (4, 77, 1024)
    for name in ref.PromptEmbeddings._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
