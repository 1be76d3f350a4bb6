"""The port's checkpoint loader held against gabby_tpu's: the safetensors
files, HF-layout directories (single file and two shards), and the
`gabby-quant` directories of `save_quantized`, each written by one package
and read by the other.

Tolerances: files and codes are held to equality (both packages quantize
with the same IEEE f32 operations: absmax, one division, round half to
even); scales to 1e-6 relative; logits of the two forwards on the same
checkpoint to 2e-2 (f32 sums in another order, bf16 activations inside the
quantized products)."""

import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gabby_tpu import config as jcfg
from gabby_tpu import loader as jloader
from gabby_tpu.models import llama as jllama
from gabby_tpu.ops import pallas as pk
from gabby_tpu.ops import quant as jquant
from gabby_tpu_torch import config as tcfg
from gabby_tpu_torch import loader as tloader
from gabby_tpu_torch.models import llama as tllama
from gabby_tpu_torch.ops import quant as tquant

TOKENS = np.array([[3, 17, 42, 9, 200, 1]], np.int32)


@pytest.fixture(autouse=True)
def _jnp_contracts():
    pk.set_kernels(False)
    yield
    pk.set_kernels(None)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _sample_arrays():
    r = np.random.default_rng(0)
    return {
        "a": r.standard_normal((4, 6)).astype(np.float32),
        "b": r.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "c": r.integers(-128, 128, (7, 3)).astype(np.int8),
        "d": r.integers(0, 1 << 20, (2, 2)).astype(np.int32),
        "e": r.standard_normal((5,)).astype(np.float16),
        "f": r.integers(0, 255, (9,)).astype(np.uint8),
    }


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def test_safetensors_files_are_identical_and_cross_read(tmp_path):
    arrays = _sample_arrays()
    jpath, tpath = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    jloader.write_safetensors(jpath, arrays)
    tloader.write_safetensors(tpath, {k: _to_torch(v)
                                      for k, v in arrays.items()})
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    # each reads the other's file
    from_j = tloader.read_safetensors(jpath)
    from_t = jloader.read_safetensors(tpath)
    assert list(from_j) == list(arrays) == list(from_t)
    for name, arr in arrays.items():
        assert from_t[name].dtype == arr.dtype
        np.testing.assert_array_equal(np.asarray(from_t[name]), arr)
        got = from_j[name]
        assert tuple(got.shape) == arr.shape
        if arr.dtype == ml_dtypes.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(got),
                                          arr.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), arr)


def test_write_safetensors_takes_numpy_arrays(tmp_path):
    arrays = {k: v for k, v in _sample_arrays().items() if k != "b"}
    jloader.write_safetensors(str(tmp_path / "j"), arrays)
    tloader.write_safetensors(str(tmp_path / "t"), arrays)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


HF_NAMES = {
    "self_attn.q_proj": "wq", "self_attn.k_proj": "wk",
    "self_attn.v_proj": "wv", "self_attn.o_proj": "wo",
    "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
    "mlp.down_proj": "w_down",
}


def write_hf_dir(path, cfg, params, *, sharded=False, gen_cfg=None):
    """Serialize gabby_tpu params in HF naming/layout (transposed linears),
    as tests/test_loader.py does; written with gabby_tpu's writer."""
    path.mkdir(parents=True, exist_ok=True)
    t = {"model.embed_tokens.weight": np.asarray(params["embed"])}
    blk = params["blocks"]
    for layer in range(cfg.num_layers):
        for hf, ours in HF_NAMES.items():
            t[f"model.layers.{layer}.{hf}.weight"] = \
                np.asarray(blk[ours][layer]).T
        t[f"model.layers.{layer}.input_layernorm.weight"] = \
            np.asarray(blk["attn_norm"][layer])
        t[f"model.layers.{layer}.post_attention_layernorm.weight"] = \
            np.asarray(blk["mlp_norm"][layer])
    t["model.norm.weight"] = np.asarray(params["final_norm"])
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = np.asarray(params["lm_head"]).T
    if sharded:
        keys = sorted(t)
        half = len(keys) // 2
        shards = {"model-00001-of-00002.safetensors": keys[:half],
                  "model-00002-of-00002.safetensors": keys[half:]}
        weight_map = {}
        for fname, ks in shards.items():
            jloader.write_safetensors(str(path / fname),
                                      {k: t[k] for k in ks})
            weight_map.update({k: fname for k in ks})
        (path / "model.safetensors.index.json").write_text(
            json.dumps({"weight_map": weight_map}))
    else:
        jloader.write_safetensors(str(path / "model.safetensors"), t)
    (path / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": list(cfg.eos_token_ids)}))
    if gen_cfg is not None:
        (path / "generation_config.json").write_text(json.dumps(gen_cfg))
    return path


@pytest.fixture(scope="module")
def tiny_setup():
    out = {}
    for tied in (False, True):
        cfg = jcfg.tiny(tie_word_embeddings=tied)
        out[tied] = (cfg, jllama.init_params(cfg, jax.random.PRNGKey(0),
                                             dtype=jnp.float32))
    return out


def assert_same_tree(jtree, ttree, path=""):
    """Float leaves equal, codes bit-equal, scales to 1e-6 relative."""
    if jtree is None or ttree is None:
        assert jtree is None and ttree is None, path
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            assert_same_tree(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, jquant.QTensor):
        assert isinstance(ttree, tquant.QTensor), path
        assert (jtree.bits, jtree.group) == (ttree.bits, ttree.group), path
        assert ttree.q.dtype == torch.int8 and \
            ttree.scale.dtype == torch.float32
        np.testing.assert_array_equal(ttree.q.numpy(), np.asarray(jtree.q),
                                      err_msg=path)
        np.testing.assert_allclose(ttree.scale.numpy(),
                                   np.asarray(jtree.scale), rtol=1e-6,
                                   atol=0, err_msg=path)
    else:
        np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree),
                                      err_msg=path)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "int8", "int4"])
@pytest.mark.parametrize("sharded", [False, True], ids=["one", "shards"])
def test_load_model_dir_matches_reference(tmp_path, tiny_setup, sharded,
                                          bits, tied):
    cfg, params = tiny_setup[tied]
    d = write_hf_dir(tmp_path / "hf", cfg, params, sharded=sharded,
                     gen_cfg={"bos_token_id": 5, "eos_token_id": [6, 7]})
    jc, jp, jtok = jloader.load_model_dir(str(d), dtype=jnp.float32,
                                          quant_bits=bits)
    tc, tp, ttok = tloader.load_model_dir(str(d), dtype=torch.float32,
                                          quant_bits=bits, device="cpu")
    assert jtok is None and ttok is None
    # the generation_config.json override reached both configs
    assert tc.bos_token_id == jc.bos_token_id == 5
    assert tc.eos_token_ids == jc.eos_token_ids == (6, 7)
    for field in tc.__dataclass_fields__:
        if field != "rope_scaling":
            assert getattr(tc, field) == getattr(jc, field), field
    assert_same_tree(jp, tp)
    if bits:
        head = tp["lm_head"]  # the int8 per-channel unembed, tied or not
        assert (head.bits, head.group) == (8, 0)
        assert tuple(head.q.shape) == (cfg.hidden_size, cfg.vocab_size)
    ref = np.asarray(jllama.forward(jp, jc, jnp.asarray(TOKENS)))
    out = tllama.forward(tp, tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-2, atol=2e-2)


def test_unembed_bits_env_is_read_at_quantize_time(tmp_path, tiny_setup,
                                                   monkeypatch):
    cfg, params = tiny_setup[False]
    d = write_hf_dir(tmp_path / "hf", cfg, params)
    monkeypatch.setenv("GABBY_UNEMBED_BITS", "4")
    _, jp, _ = jloader.load_model_dir(str(d), dtype=jnp.float32,
                                      quant_bits=4)
    _, tp, _ = tloader.load_model_dir(str(d), dtype=torch.float32,
                                      quant_bits=4, device="cpu")
    assert tp["lm_head"].bits == 4 and tp["lm_head"].group > 0
    assert_same_tree(jp, tp)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_quantized_checkpoint_crosses_packages(tmp_path, tiny_setup, bits,
                                               writer):
    """save_quantized by one package loads in the other; the forwards on
    the loaded trees agree."""
    cfg, params = tiny_setup[True]
    src = write_hf_dir(tmp_path / "hf", cfg, params)
    (src / "special_tokens_map.json").write_text("{}")  # copied alongside
    out = tmp_path / "quantized"
    if writer == "reference":
        c1, q1, _ = jloader.load_model_dir(str(src), dtype=jnp.float32,
                                           quant_bits=bits)
        jloader.save_quantized(str(out), c1, q1, bits, src_dir=str(src))
    else:
        c1, q1, _ = tloader.load_model_dir(str(src), dtype=torch.float32,
                                           quant_bits=bits, device="cpu")
        tloader.save_quantized(str(out), c1, q1, bits, src_dir=str(src))
    assert (out / "special_tokens_map.json").exists()
    assert (out / "config.json").exists()
    meta = json.loads((out / "gabby.json").read_text())
    assert meta["config"]["fused_tp"] == 1
    assert meta["int4_packing"] == "halfsplit" and meta["bits"] == bits

    jc, jp, jbits = jloader.load_quantized(str(out), dtype=jnp.float32)
    tc, tp, tbits = tloader.load_quantized(str(out), dtype=torch.float32,
                                           device="cpu")
    assert jbits == tbits == bits
    assert_same_tree(jp, tp)
    assert tp["blocks"]["wq"].bits == bits
    ref = np.asarray(jllama.forward(jp, jc, jnp.asarray(TOKENS)))
    out_logits = tllama.forward(tp, tc, torch.from_numpy(TOKENS).long())
    np.testing.assert_allclose(out_logits.numpy(), ref, rtol=2e-2, atol=2e-2)
    # max_seq override applies to prequantized checkpoints too
    tc2, _, _ = tloader.load_model_dir(str(out), max_seq_len=64,
                                       device="cpu")
    assert tc2.max_seq_len == 64


@pytest.mark.parametrize("bits", [8, 4])
def test_both_packages_write_the_same_checkpoint(tmp_path, tiny_setup, bits):
    cfg, params = tiny_setup[False]
    src = write_hf_dir(tmp_path / "hf", cfg, params)
    jc, jq, _ = jloader.load_model_dir(str(src), dtype=jnp.float32,
                                       quant_bits=bits)
    tc, tq, _ = tloader.load_model_dir(str(src), dtype=torch.float32,
                                       quant_bits=bits, device="cpu")
    jloader.save_quantized(str(tmp_path / "j"), jc, jq, bits)
    tloader.save_quantized(str(tmp_path / "t"), tc, tq, bits)
    assert (json.loads((tmp_path / "j" / "gabby.json").read_text())
            == json.loads((tmp_path / "t" / "gabby.json").read_text()))
    jflat = jloader.read_safetensors(str(tmp_path / "j" / "model.safetensors"))
    tflat = jloader.read_safetensors(str(tmp_path / "t" / "model.safetensors"))
    assert list(jflat) == list(tflat)
    for name in jflat:
        assert jflat[name].dtype == tflat[name].dtype, name
        if name.endswith(".scale"):
            np.testing.assert_allclose(tflat[name], jflat[name], rtol=1e-6,
                                       atol=0)
        else:
            np.testing.assert_array_equal(np.asarray(tflat[name]),
                                          np.asarray(jflat[name]), name)


@pytest.fixture()
def int8_checkpoint(tmp_path):
    cfg = tcfg.tiny()
    params = tquant.quantize_tree(
        tllama.init_params(cfg, dtype=torch.float32, device="cpu"), 8)
    d = tmp_path / "ckpt"
    tloader.save_quantized(str(d), cfg, params, 8)
    return d


def _rewrite_meta(d, fn):
    meta = json.loads((d / "gabby.json").read_text())
    fn(meta)
    (d / "gabby.json").write_text(json.dumps(meta))


def test_load_quantized_legacy_bare_int_qbits(int8_checkpoint):
    """Older checkpoints stored qbits values as bare ints and named no
    packing: legacy INT8 loads, legacy INT4 is refused with the
    re-quantize message (its packed bytes are the interleaved layout)."""
    d = int8_checkpoint

    def legacy(meta):
        meta["qbits"] = {k: v[0] for k, v in meta["qbits"].items()}
        meta.pop("int4_packing")
    _rewrite_meta(d, legacy)
    _, params, bits = tloader.load_quantized(str(d), device="cpu")
    assert bits == 8
    assert params["blocks"]["wq"].bits == 8 and params["blocks"]["wq"].group == 0
    jloader.load_quantized(str(d))  # the reference reads the same file

    _rewrite_meta(d, lambda meta: meta.update(bits=4))
    with pytest.raises(ValueError, match="re-run"):
        tloader.load_quantized(str(d), device="cpu")


def test_load_quantized_refuses_interleaved_int4(tmp_path):
    cfg = tcfg.tiny()
    params = tquant.quantize_tree(
        tllama.init_params(cfg, dtype=torch.float32, device="cpu"), 4)
    d = tmp_path / "ckpt"
    tloader.save_quantized(str(d), cfg, params, 4)
    tloader.load_quantized(str(d), device="cpu")
    _rewrite_meta(d, lambda meta: meta.update(int4_packing="interleaved"))
    with pytest.raises(ValueError, match="interleaved"):
        tloader.load_quantized(str(d), device="cpu")
    _rewrite_meta(d, lambda meta: meta.update(format="other"))
    with pytest.raises(ValueError, match="not a gabby checkpoint"):
        tloader.load_quantized(str(d), device="cpu")


def test_fused_tp_in_gabby_json(int8_checkpoint):
    """The reference writes its `fused_tp` field into gabby.json: 1 (plain
    concatenation) is accepted, and a tree fused for tp = 2 loads at tp = 2
    and is refused at tp = 1."""
    d = int8_checkpoint
    assert json.loads((d / "gabby.json").read_text())["config"]["fused_tp"] == 1
    jc, _, _ = jloader.load_quantized(str(d))
    assert jc.fused_tp == 1
    _rewrite_meta(d, lambda meta: meta["config"].pop("fused_tp"))
    tloader.load_quantized(str(d), device="cpu")  # absent: older files
    _rewrite_meta(d, lambda meta: meta["config"].update(fused_tp=2))
    cfg, _, _ = tloader.load_quantized(str(d), device="cpu", tp=2)
    assert cfg.fused_tp == 2
    with pytest.raises(ValueError, match="fused for tp=2"):
        tloader.load_quantized(str(d), device="cpu")


def test_load_model_dir_reads_the_tokenizer(tmp_path, tiny_setup):
    cfg, params = tiny_setup[False]
    d = write_hf_dir(tmp_path / "hf", cfg, params)
    shutil.copy("tests/fixtures/multilingual_tokenizer.json",
                d / "tokenizer.json")
    _, _, tok = tloader.load_model_dir(str(d), dtype=torch.float32,
                                       device="cpu")
    assert tok.token_id("<|begin_of_text|>") == 853
    assert tok.decode(tok.encode("hello world")) == "hello world"


HF_CONFIGS = {
    "llama32": {
        "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
        "num_hidden_layers": 16, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5,
        "rope_theta": 500000.0, "tie_word_embeddings": True,
        "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009],
        "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                         "low_freq_factor": 1.0,
                         "original_max_position_embeddings": 8192,
                         "rope_type": "llama3"}},
    "defaults": {
        "vocab_size": 32000, "hidden_size": 512, "intermediate_size": 1024,
        "num_hidden_layers": 4, "num_attention_heads": 8,
        "eos_token_id": 2},
    "legacy_rope_key": {
        "vocab_size": 1000, "hidden_size": 128, "intermediate_size": 256,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "rope_scaling": {"type": "llama3", "factor": 8.0,
                         "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                         "original_max_position_embeddings": 4096}},
    "other_rope": {
        "vocab_size": 1000, "hidden_size": 128, "intermediate_size": 256,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "rope_scaling": {"rope_type": "linear", "factor": 2.0}},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_dict_matches_reference(tmp_path, name):
    d = HF_CONFIGS[name]
    ref = jcfg.ModelConfig.from_hf_dict(d, max_seq_len=1024)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    for got in (tcfg.ModelConfig.from_hf_dict(d, max_seq_len=1024),
                tcfg.ModelConfig.from_json_file(str(path), max_seq_len=1024)):
        for field in got.__dataclass_fields__:
            if field == "rope_scaling":
                assert ((got.rope_scaling and got.rope_scaling.__dict__)
                        == (ref.rope_scaling and ref.rope_scaling.__dict__))
            else:
                assert getattr(got, field) == getattr(ref, field), field
    assert got.max_seq_len == 1024
