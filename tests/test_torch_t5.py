"""PyTorch/CUDA port: T5 (SD3's third tower), its tokenizer and the masked
attention route, against the JAX package, in fp32 on the CPU.

The port's T5 encoder gets torch weights, and the JAX ``t5.apply`` the same
weights through ``io/torch_convert.py``; the last hidden states agree within
1e-4.  The port's copy of the SentencePiece-unigram tokenizer gives the same
ids as the JAX tokenizer on the same files.  An additive mask (T5's position
bias) on the card takes the counted plain route, with its scale as given.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stablediffusion_tpu.models import t5 as jt5
from stablediffusion_tpu.ops.attention import attention_xla
from stablediffusion_tpu.tokenizer.sentencepiece_unigram import (
    SentencePieceUnigramTokenizer as JTokenizer,
)
from stablediffusion_tpu.utils.testing import bench_t5_tokenizer as jax_bench_t5_tokenizer
from stablediffusion_tpu_torch.models import t5 as tt5
from stablediffusion_tpu_torch.ops import attention as tattn
from stablediffusion_tpu_torch.tokenizer.sentencepiece_unigram import (
    SentencePieceUnigramTokenizer,
)
from stablediffusion_tpu_torch.utils.testing import bench_t5_tokenizer
from test_t5_tokenizer import CORPUS, _write_spiece_model, make_vocab
from torch_port_helpers import _init, _jax_cfg, jax_tree, port_test_module  # noqa: F401

ATOL = 1e-4


def test_t5_configs_match_jax():
    for name in ("T5_XXL", "tiny_t5_config", "T5Config"):
        get = lambda mod: getattr(mod, name)() if callable(getattr(mod, name)) \
            else getattr(mod, name)  # noqa: E731
        assert dataclasses.asdict(get(tt5)) == dataclasses.asdict(get(jt5))
    d = {"d_model": 4096, "num_layers": 24, "num_heads": 64, "d_ff": 10240,
         "architectures": ["T5EncoderModel"], "feed_forward_proj": "gated-gelu"}
    assert (dataclasses.asdict(tt5.T5Config.from_diffusers_dict(d))
            == dataclasses.asdict(jt5.T5Config.from_diffusers_dict(d)))


@pytest.mark.parametrize("buckets, distance", [(32, 128), (16, 20), (8, 8)])
def test_relative_position_bucket_matches_jax(buckets, distance):
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 7)[:, None] * 40
    np.testing.assert_array_equal(tt5._relative_position_bucket(rel, buckets, distance),
                                  jt5._relative_position_bucket(rel, buckets, distance))


@pytest.mark.parametrize("seq_len", [1, 77, 256])
def test_position_bias_matches_jax(seq_len):
    cfg = tt5.tiny_t5_config()
    table = np.random.default_rng(seq_len).standard_normal((32, cfg.num_heads)).astype(np.float32)
    ref = np.asarray(jt5.compute_position_bias(jnp.asarray(table), seq_len,
                                               _jax_cfg(jt5.T5Config, cfg)))
    out = tt5.compute_position_bias(torch.from_numpy(table), seq_len, cfg).numpy()
    assert out.shape == (1, cfg.num_heads, seq_len, seq_len)
    np.testing.assert_array_equal(out, ref)


def _pair(cfg, seed=0):
    model = _init(tt5.T5EncoderModel(cfg), torch.Generator().manual_seed(seed))
    return model, jax_tree(model)


@pytest.mark.parametrize("variant", ["gated_gelu", "relu_v1_0", "attention_mask"])
def test_t5_matches_jax(variant):
    """The whole stack (bias shared from block 0, RMSNorm, gated tanh-GELU
    or relu) against ``t5.apply``; with an attention mask too."""
    cfg = tt5.tiny_t5_config()
    if variant == "relu_v1_0":
        cfg = dataclasses.replace(cfg, dense_act_fn="relu")
    model, tree = _pair(cfg)
    assert "relative_attention_bias" not in str(
        [k for k in model.state_dict() if k.startswith("encoder.block.1")])
    r = np.random.default_rng(1)
    ids = r.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    mask = None
    if variant == "attention_mask":
        mask = np.ones((2, 24), np.int32)
        mask[1, 17:] = 0
    ref = np.asarray(jt5.apply(tree, _jax_cfg(jt5.T5Config, cfg), jnp.asarray(ids),
                               None if mask is None else jnp.asarray(mask)))
    out = model(torch.from_numpy(ids).long(),
                None if mask is None else torch.from_numpy(mask)).numpy()
    assert out.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_t5_state_dict_names_match_the_jax_tree():
    import jax

    cfg = tt5.tiny_t5_config()
    from stablediffusion_tpu_torch.io.from_jax import flatten

    jtree = jax.eval_shape(lambda: jt5.init_params(jax.random.key(0), _jax_cfg(jt5.T5Config, cfg)))
    assert sorted(flatten(jax_tree(tt5.T5EncoderModel(cfg)))) == sorted(flatten(jtree))


def test_masked_route_keeps_the_scale():
    """A masked call's route, and `scale=1.0` reaching the plain version as
    given (T5 has no 1/sqrt(d)), against ``attention_xla``."""
    assert tattn._route((1, 256, 64, 64), (1, 256, 64, 64), False, "cuda",
                        masked=True) == "plain_masked"
    assert tattn._route((1, 256, 64, 64), (1, 256, 64, 64), False, "cuda",
                        needs_grad=True, masked=True) == "plain_masked"
    assert tattn._route((1, 256, 64, 64), (1, 256, 64, 64), False, "cpu",
                        masked=True) == "plain"
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((2, 12, 4, 8)).astype(np.float32) for _ in range(3))
    bias = r.standard_normal((1, 4, 12, 12)).astype(np.float32)
    for scale in (1.0, None):
        ref = np.asarray(attention_xla(*(jnp.asarray(t) for t in (q, k, v)),
                                       mask=jnp.asarray(bias), scale=scale))
        before = tattn.ATTENTION_MASKED_LAUNCHES.count
        out = tattn.attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              mask=torch.from_numpy(bias), scale=scale).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        # the counter counts the card's masked calls only
        assert tattn.ATTENTION_MASKED_LAUNCHES.count == before


def _ids(tok, texts, max_length=32):
    return np.asarray(tok(texts, max_length=max_length))


def test_tokenizer_ids_match_jax(tmp_path):
    """The same files give the same ids in both packages: spiece.model, and
    tokenizer.json written by either package's save_pretrained."""
    spiece = tmp_path / "spiece"
    spiece.mkdir()
    _write_spiece_model(str(spiece / "spiece.model"), make_vocab())
    ours, theirs = (SentencePieceUnigramTokenizer.from_pretrained(str(spiece)),
                    JTokenizer.from_pretrained(str(spiece)))
    np.testing.assert_array_equal(_ids(ours, CORPUS), _ids(theirs, CORPUS))
    texts = CORPUS + ["a photograph of an astronaut riding a horse <extra_id_0>",
                      "<extra_id_3> snow <extra_id_1>"]
    bench_t5_tokenizer(extra_ids=4).save_pretrained(str(tmp_path / "port"))
    jax_bench_t5_tokenizer(extra_ids=4).save_pretrained(str(tmp_path / "jax"))
    for d in ("port", "jax"):
        a = SentencePieceUnigramTokenizer.from_pretrained(str(tmp_path / d))
        b = JTokenizer.from_pretrained(str(tmp_path / d))
        np.testing.assert_array_equal(_ids(a, texts, 24), _ids(b, texts, 24))
        assert a.vocab_size == b.vocab_size
        assert [a.decode(list(x)) for x in _ids(a, texts)] == \
            [b.decode(list(x)) for x in _ids(b, texts)]
    with open(tmp_path / "port" / "tokenizer.json") as f, \
            open(tmp_path / "jax" / "tokenizer.json") as g:
        assert f.read() == g.read()
