"""The translation slice of the PyTorch port against the JAX package, on the
CPU: the MT golden, the encoder-decoder, incremental decoding (causal EVA and
the softmax KV cache), beam search, BLEU, token collation and the generate
CLI.

Weights and inputs are drawn with numpy and handed to both packages (JAX at
``highest`` matmul precision, torch without TF32).  Tolerances:

* ``mt_eva_causal.npz`` logits and the model against JAX: 1e-4 / 1e-4
  (``test_interop.py``'s), encoder states at non-pad positions;
* causal EVA, full against incremental: 3e-4 (``test_causal_eva.py``'s);
  the port's and JAX's ``decode_step`` outputs 3e-5 / 1e-4;
* beam search: every returned token row equal, scores 1e-4;
* BLEU, collation and the CLI's batches: exact.
"""
import json
import os
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import exact_float32, randomize, to_jax
from efficient_attention_tpu.attention.causal_eva import (
    CausalEVAttention as JaxCausalEVA,
)
from efficient_attention_tpu.attention.causal_eva import (
    reorder_decode_state as jax_reorder,
)
from efficient_attention_tpu.cli import generate as jax_generate
from efficient_attention_tpu.data import text_data as jax_text_data
from efficient_attention_tpu.generation import SequenceGenerator as JaxGenerator
from efficient_attention_tpu.models.transformer import (
    CausalSelfAttention as JaxSoftmaxSelfAttention,
)
from efficient_attention_tpu.models.transformer import TransformerModel as JaxModel
from efficient_attention_tpu.scoring.bleu import BleuScorer as JaxBleu
from efficient_attention_torch.attention.causal_eva import (
    CausalEVAttention,
    reorder_decode_state,
)
from efficient_attention_torch.cli import generate
from efficient_attention_torch.data.text_data import collate_tokens
from efficient_attention_torch.generation.beam_search import SequenceGenerator
from efficient_attention_torch.interop import (
    lm_state_dict_from_jax,
    mt_state_dict_from_fairseq,
    mt_state_dict_from_jax,
)
from efficient_attention_torch.models.transformer import (
    CausalSelfAttention,
    TransformerModel,
)
from efficient_attention_torch.scoring.bleu import BleuScorer

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
LM_TOL = dict(atol=1e-4, rtol=1e-4)
MOD_TOL = dict(atol=3e-5, rtol=1e-4)
# the small WMT-shaped model: 2 + 2 layers, dim 48, 3 heads of 16, vocab
# 120, the recipe's attention flags
ENC_ARGS = dict(window_size=8, num_landmarks=8, overlap_window=True,
                use_t5_rpe=True, adaptive_proj="no-ln", attn_2d=False,
                use_rpe=False)
DEC_ARGS = dict(window_size=16, chunk_size=8, adaptive_proj="qk", causal=True)
MODEL = dict(src_vocab_size=120, tgt_vocab_size=120, embed_dim=48, ffn_dim=96,
             num_layers=2, num_heads=3, attn_name_encoder="eva",
             attn_args_encoder=ENC_ARGS, attn_name_decoder="causal_eva",
             attn_args_decoder=DEC_ARGS, dropout=0.1, max_len=256,
             share_all_embeddings=True)
CLI_ARGV = [
    "--dummy-data", "--dummy-vocab", "120", "--encoder-embed-dim", "48",
    "--encoder-ffn-embed-dim", "96", "--encoder-layers", "2",
    "--encoder-attention-heads", "3", "--attn-name-encoder", "eva",
    "--encoder-attn-window-size", "8", "--encoder-attn-num-landmarks", "8",
    "--encoder-attn-overlap-window", "--encoder-attn-use-t5-rpe",
    "--encoder-attn-adaptive-proj", "no-ln", "--attn-name-decoder", "causal_eva",
    "--decoder-attn-window-size", "16", "--decoder-attn-chunk-size", "8",
    "--decoder-attn-adaptive-proj", "qk", "--decoder-attn-causal",
    "--share-all-embeddings", "--beam", "4", "--lenpen", "0.6",
    "--gen-batch", "4", "--gen-subset-size", "6", "--max-len-b", "12",
]


@pytest.fixture(autouse=True)
def _f32():
    with exact_float32():
        yield


def _sources(seed, lengths, T):
    rng = np.random.default_rng(seed)
    return collate_tokens([np.concatenate([rng.integers(4, 120, n - 1), [2]])
                           for n in lengths], pad_idx=1, pad_to_length=T)


@pytest.fixture(scope="module")
def models():
    """The JAX model with numpy-drawn params and the port's model carrying
    them (strict load), in eval mode."""
    jm = JaxModel(**MODEL)
    dummy = jnp.ones((1, 16), jnp.int32)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), dummy, dummy), 5)
    tm = TransformerModel(**MODEL)
    tm.load_state_dict(mt_state_dict_from_jax(params), strict=True)
    return jm, to_jax(params), tm.eval()


def test_mt_golden_loads_strictly_and_matches():
    data = np.load(os.path.join(GOLDENS, "mt_eva_causal.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files if k.startswith("sd__")}
    m = TransformerModel(
        120, 120, embed_dim=48, ffn_dim=96, num_layers=2, num_heads=2,
        attn_name_encoder="eva",
        attn_args_encoder=dict(ENC_ARGS, window_size=4, num_landmarks=4),
        attn_name_decoder="causal_eva",
        attn_args_decoder=dict(DEC_ARGS, window_size=4, chunk_size=2,
                               use_t5_rpe=True),
        dropout=0.0, max_len=1024, share_all_embeddings=True)
    m.load_state_dict(mt_state_dict_from_fairseq(sd), strict=True)
    with torch.no_grad():
        logits = m.eval()(torch.from_numpy(data["src"]), torch.from_numpy(data["prev"]))
    np.testing.assert_allclose(logits.numpy(), data["logits"], **LM_TOL)
    bad = dict(sd, **{"decoder.output_projection.weight": sd["encoder.embed_tokens.weight"] + 1})
    with pytest.raises(ValueError, match="mirror"):
        mt_state_dict_from_fairseq(bad)


def test_model_matches_jax_on_padded_sources(models):
    """Encoder states at non-pad positions and teacher-forced logits, on
    sources of 31 and 18 tokens padded to 32 (K4's plain version in every
    encoder layer)."""
    jm, params, tm = models
    src = _sources(0, [31, 18], 32)
    prev = _sources(1, [20, 9], 24)
    enc, pad = jax.jit(partial(jm.apply, method=JaxModel.encode))(
        params, jnp.asarray(src))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(src), jnp.asarray(prev)))
    with torch.no_grad():
        tenc, tpad = tm.encode(torch.from_numpy(src))
        got = tm(torch.from_numpy(src), torch.from_numpy(prev)).numpy()
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(pad))
    keep = src != 1
    np.testing.assert_allclose(tenc.numpy()[keep], np.asarray(enc)[keep], **LM_TOL)
    np.testing.assert_allclose(got, want, **LM_TOL)


ATTN = dict(embed_dim=48, num_heads=3, window_size=8, chunk_size=4,
            causal=True, adaptive_proj="qk")


def _causal_pair(seed=0, T=40, **kw):
    jm = JaxCausalEVA(impl="xla", **{**ATTN, **kw})
    x = np.random.default_rng(seed).standard_normal((2, T, 48)).astype(np.float32)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                       seed + 1)
    tm = CausalEVAttention(**{**ATTN, **kw})
    tm.load_state_dict(lm_state_dict_from_jax(params), strict=True)
    return jm, to_jax(params), tm.eval(), x


def _decode(tm, x, max_len=None):
    state = tm.init_decode_state(x.shape[0], max_len or x.shape[1])
    outs = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            out, state = tm.decode_step(state, torch.from_numpy(x[:, t:t + 1]))
            outs.append(out)
    return torch.cat(outs, dim=1).numpy(), state


@pytest.mark.parametrize("kw", [dict(), dict(use_t5_rpe=True),
                                dict(overlap_window=True, use_t5_rpe=True)])
def test_causal_eva_incremental_matches_full_and_jax(kw):
    """The port's decode steps against its parallel path (T = 40, five
    windows, ten chunks), and against JAX's decode steps on the same
    weights."""
    jm, params, tm, x = _causal_pair(**kw)
    with torch.no_grad():
        full = tm(torch.from_numpy(x)).numpy()
    incremental, state = _decode(tm, x)
    assert state.pos == 40
    np.testing.assert_allclose(incremental, full, atol=3e-4)
    jstate = jm.apply(params, 2, 40, method=JaxCausalEVA.init_decode_state)
    step = jax.jit(partial(jm.apply, method=JaxCausalEVA.decode_step))
    want = []
    for t in range(x.shape[1]):
        out, jstate = step(params, jstate, jnp.asarray(x[:, t:t + 1]))
        want.append(np.asarray(out))
    np.testing.assert_allclose(incremental, np.concatenate(want, axis=1), **MOD_TOL)


def test_reorder_decode_state_matches_jax():
    """Beam reordering gathers every buffer and leaves ``pos``: one more
    step in both orders gives permuted outputs, as in JAX."""
    jm, params, tm, x = _causal_pair(seed=2, T=12)
    x = np.concatenate([x, x[::-1]], axis=0)  # batch 4
    _, state = _decode(tm, x[:, :9], max_len=12)
    order = np.array([3, 2, 1, 0])
    re_state = reorder_decode_state(state, torch.from_numpy(order))
    assert re_state.pos == state.pos == 9
    jstate = jm.apply(params, 4, 12, method=JaxCausalEVA.init_decode_state)
    step = jax.jit(partial(jm.apply, method=JaxCausalEVA.decode_step))
    for t in range(9):
        _, jstate = step(params, jstate, jnp.asarray(x[:, t:t + 1]))
    jre = jax_reorder(jstate, jnp.asarray(order))
    want, _ = step(params, jre, jnp.asarray(x[order, 9:10]))
    with torch.no_grad():
        o1, _ = tm.decode_step(state, torch.from_numpy(x[:, 9:10]))
        o2, _ = tm.decode_step(re_state, torch.from_numpy(x[order, 9:10]))
    np.testing.assert_allclose(o1.numpy()[order], o2.numpy(), atol=1e-6)
    np.testing.assert_allclose(o2.numpy(), np.asarray(want), **MOD_TOL)


def test_softmax_kv_cache_decode_matches_jax():
    jm = JaxSoftmaxSelfAttention(embed_dim=48, num_heads=3)
    x = np.random.default_rng(4).standard_normal((2, 10, 48)).astype(np.float32)
    np_params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    params = to_jax(np_params)
    tm = CausalSelfAttention(48, 3)
    tm.load_state_dict(lm_state_dict_from_jax(np_params), strict=True)
    state = tm.eval().init_decode_state(2, 12)
    jstate = jm.apply(params, 2, 12, method=JaxSoftmaxSelfAttention.init_decode_state)
    step = jax.jit(partial(jm.apply, method=JaxSoftmaxSelfAttention.decode_step))
    with torch.no_grad():
        full = tm(torch.from_numpy(x)).numpy()
    for t in range(10):
        want, jstate = step(params, jstate, jnp.asarray(x[:, t:t + 1]))
        with torch.no_grad():
            got, state = tm.decode_step(state, torch.from_numpy(x[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)
        np.testing.assert_allclose(got.numpy()[:, 0], full[:, t], **MOD_TOL)
    assert state.pos == 10


@pytest.mark.parametrize("len_kw", [dict(min_len=1),
                                    dict(min_len=3, max_len_a=0.5, max_len_b=4)])
def test_beam_search_matches_jax(models, len_kw):
    """Beam 4, lenpen 0.6, on the small model's encoder states: every
    returned token row equal to JAX's, scores within 1e-4."""
    jm, params, tm = models
    src = _sources(6, [15, 9, 12], 16)
    B, K, L = 3, 4, 16
    src_lens = (src != 1).sum(axis=1)
    enc, pad = jax.jit(partial(jm.apply, method=JaxModel.encode))(
        params, jnp.asarray(src))
    enc_k, pad_k = jnp.repeat(enc, K, axis=0), jnp.repeat(pad, K, axis=0)

    def jstep(cache, tokens, step):
        logits, cache = jm.apply(params, cache, tokens, step, None, pad_k,
                                 method=JaxModel.decode_step)
        return logits[:, 0], cache

    jgen = JaxGenerator(jstep, lambda bk, ml: jm.apply(
        params, bk, ml, jnp.float32, enc_k, method=JaxModel.init_decode_state),
        vocab_size=120, beam_size=K, max_len=L, len_penalty=0.6, **len_kw)
    want_tok, want_sc = jgen.generate(batch=B, src_lengths=jnp.asarray(src_lens))

    with torch.no_grad():
        tenc, tpad = tm.encode(torch.from_numpy(src))
        tenc_k, tpad_k = tenc.repeat_interleave(K, 0), tpad.repeat_interleave(K, 0)

        def tstep(cache, tokens, step):
            logits, cache = tm.decode_step(cache, tokens, step, None, tpad_k)
            return logits[:, 0], cache

        tgen = SequenceGenerator(tstep, lambda bk, ml: tm.init_decode_state(
            bk, ml, enc_out=tenc_k), vocab_size=120, beam_size=K, max_len=L,
            len_penalty=0.6, **len_kw)
        got_tok, got_sc = tgen.generate(B, src_lengths=torch.from_numpy(src_lens))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc), **LM_TOL)


def test_bleu_matches_jax():
    rng = np.random.default_rng(8)
    ours, theirs = BleuScorer(), JaxBleu()
    for _ in range(20):
        ref = rng.integers(1, 12, rng.integers(3, 20)).tolist()
        hyp = rng.integers(1, 12, rng.integers(3, 20)).tolist()
        ours.add(ref, hyp)
        theirs.add(ref, hyp)
    assert ours.score() == theirs.score() > 0
    assert ours.result_string() == theirs.result_string()


@pytest.mark.parametrize("kw", [dict(), dict(pad_to_length=20),
                                dict(move_eos_to_beginning=True)])
def test_collate_tokens_matches_jax(kw):
    samples = [np.array([5, 6, 7, 2]), np.array([9, 2]), np.arange(4, 15)]
    np.testing.assert_array_equal(collate_tokens(samples, pad_idx=1, **kw),
                                  jax_text_data.collate_tokens(samples, pad_idx=1, **kw))


def test_generate_cli_runs_and_batches_as_jax(capsys):
    """``cli.generate --device cpu`` prints its JSON line with a finite BLEU;
    its dummy pairs, source bucketing and buffer lengths are the ones the
    JAX CLI builds from the same flags."""
    args = generate.parse_args(CLI_ARGV + ["--device", "cpu"])
    result = generate.main(args)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == {"bleu", "sentences"} and line["sentences"] == 6
    assert np.isfinite(line["bleu"]) and line["bleu"] == result["bleu"]

    jargs = jax_generate.parse_args(CLI_ARGV)
    jsrc, jtgt, _, _ = jax_generate.load_pairs(jargs)
    src, tgt, _, _ = generate.load_pairs(args)
    assert len(src) == len(jsrc) == 512
    for a, b in ((src, jsrc), (tgt, jtgt)):
        assert all(np.array_equal(a[i], b[i]) for i in range(len(a)))
    seen = []

    class Recorder:
        def __init__(self, *a, max_len, **kw):
            self.max_len, self.kw = max_len, kw

        def generate(self, batch, prefix_tokens=None, src_lengths=None, ctx=None):
            seen.append((batch, self.max_len, np.asarray(src_lengths),
                         np.asarray(ctx[2])))
            tokens = jnp.full((batch, 4, self.max_len + 1), 2, jnp.int32)
            return tokens, jnp.zeros((batch, 4))

    # the batching does not depend on the model: a one-layer stand-in keeps
    # JAX's eager encoder calls short
    tiny = JaxModel(src_vocab_size=120, tgt_vocab_size=120, embed_dim=8,
                    ffn_dim=8, num_layers=1, num_heads=1)
    with mock.patch("efficient_attention_tpu.generation.SequenceGenerator", Recorder), \
            mock.patch.object(jax_generate, "build_model", lambda *a: tiny):
        jax_generate.main(jargs)
    ours = list(generate.generation_batches(args, src))
    assert len(ours) == len(seen) == 2
    for (chunk, src_b, src_lens, buf_len, _), (B, jbuf, jlens, jpad) in zip(ours, seen):
        assert len(chunk) == B and buf_len == jbuf
        np.testing.assert_array_equal(src_lens, jlens)
        # the source padding (True = pad) as the JAX encoder saw it, per beam
        np.testing.assert_array_equal(np.repeat(src_b == 1, 4, axis=0), jpad)
