"""HTTP round trips through the unchanged C++ front-end (cpp/) into the
PyTorch port's server (`gabby_tpu_torch.server.main --device cpu`): the
tiny preset with random weights, and a `gabby-quant` checkpoint directory
that `python -m gabby_tpu_torch.tools.quantize` wrote from an HF-layout
directory, served with `--model-dir` and the fixture BPE tokenizer. Skips
where the native front-end cannot be built, as tests/test_server.py does."""

import contextlib
import http.client
import json
import os
import shutil
import subprocess
import sys
import threading

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAT = {"model": "tiny", "max_tokens": 5,
        "messages": [{"role": "system", "content": "s"},
                     {"role": "user", "content": "hello"}]}


@contextlib.contextmanager
def _serving(argv):
    """The port's server on a thread; yields the bound port."""
    try:
        from gabby_tpu_torch.bridge import build_native
        build_native()
    except Exception as e:  # no toolchain in this environment
        pytest.skip(f"native front-end unavailable: {e}")
    from gabby_tpu_torch import server

    ready, stop = threading.Event(), threading.Event()
    bound: list[int] = []

    def on_ready(p):
        bound.append(p)
        ready.set()

    # the caller's flags come last, so they override these
    argv = ["--device", "cpu", "--port", "0", "--slots", "2",
            "--max-seq", "128", "--kv-quant", "--no-warmup",
            "--log-level", "0", "--workers", "2"] + argv
    th = threading.Thread(target=server.main, args=(argv,),
                          kwargs=dict(on_ready=on_ready, stop=stop),
                          daemon=True)
    th.start()
    assert ready.wait(120), "server did not come up"
    yield bound[0]
    stop.set()
    th.join(60)
    assert not th.is_alive()


@pytest.fixture(scope="module")
def port():
    with _serving(["--preset", "tiny", "--random-weights",
                   "--quant", "4"]) as p:
        yield p


def write_tiny_hf_dir(path) -> None:
    """An HF-layout directory of the tiny model (seed-0 random weights,
    bf16) whose tokenizer.json is the fixture BPE tokenizer: 859 ids with
    the Llama-3 chat tokens, so vocab_size is 1024 and BOS/EOS are the
    fixture's ids."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch import loader
    from gabby_tpu_torch.models import llama

    cfg = cfglib.tiny(vocab_size=1024, tie_word_embeddings=True,
                      bos_token_id=853, eos_token_ids=(854, 857))
    p = llama.init_params(cfg, dtype=torch.bfloat16, device="cpu")
    os.makedirs(path)
    names = {"self_attn.q_proj": "wq", "self_attn.k_proj": "wk",
             "self_attn.v_proj": "wv", "self_attn.o_proj": "wo",
             "mlp.gate_proj": "w_gate", "mlp.up_proj": "w_up",
             "mlp.down_proj": "w_down"}
    t = {"model.embed_tokens.weight": p["embed"],
         "model.norm.weight": p["final_norm"]}
    for layer in range(cfg.num_layers):
        pre = f"model.layers.{layer}."
        for hf, ours in names.items():
            t[f"{pre}{hf}.weight"] = p["blocks"][ours][layer].T
        t[pre + "input_layernorm.weight"] = p["blocks"]["attn_norm"][layer]
        t[pre + "post_attention_layernorm.weight"] = \
            p["blocks"]["mlp_norm"][layer]
    loader.write_safetensors(os.path.join(path, "model.safetensors"), t)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size,
                   "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
                   "tie_word_embeddings": True, "bos_token_id": 0,
                   "eos_token_id": 1}, f)
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump({"bos_token_id": 853, "eos_token_id": [854, 857]}, f)
    shutil.copy(os.path.join(REPO, "tests", "fixtures",
                             "multilingual_tokenizer.json"),
                os.path.join(path, "tokenizer.json"))


@pytest.fixture(scope="module")
def quantized_dir(tmp_path_factory):
    """`python -m gabby_tpu_torch.tools.quantize` run as a user runs it."""
    root = tmp_path_factory.mktemp("ckpt")
    hf, out = str(root / "tiny-hf"), str(root / "tiny-int8")
    write_tiny_hf_dir(hf)
    run = subprocess.run(
        [sys.executable, "-m", "gabby_tpu_torch.tools.quantize",
         "--model-dir", hf, "--out", out, "--bits", "8", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert f"wrote {out} (bits=8)" in run.stdout
    return hf, out


def test_tools_quantize_writes_a_standalone_directory(quantized_dir):
    from gabby_tpu_torch import loader
    _, out = quantized_dir
    assert sorted(os.listdir(out)) == [
        "config.json", "gabby.json", "generation_config.json",
        "model.safetensors", "tokenizer.json"]
    cfg, params, tok = loader.load_model_dir(out, device="cpu")
    assert cfg.vocab_size == 1024 and cfg.eos_token_ids == (854, 857)
    assert params["blocks"]["wq"].bits == 8
    assert params["lm_head"].bits == 8 and params["lm_head"].q.dim() == 2
    assert params["embed"].dtype == torch.bfloat16
    assert tok.token_id("<|eot_id|>") == 857


@pytest.mark.parametrize("kind", ["gabby-quant", "hf-quant-8", "hf-bf16"])
def test_model_dir_serves_a_chat_completion(quantized_dir, kind):
    hf, out = quantized_dir
    argv = {"gabby-quant": ["--model-dir", out],
            "hf-quant-8": ["--model-dir", hf, "--quant", "8"],
            "hf-bf16": ["--model-dir", hf + "/"]}[kind]
    with _serving(argv) as p:
        status, body = _post(p, {**CHAT, "model": "m"})
        assert status == 200, body
        reply = json.loads(body)
        # the model id is the directory's name
        conn = http.client.HTTPConnection("127.0.0.1", p, timeout=120)
        conn.request("GET", "/v1/models")
        models = conn.getresponse().read().decode()
        conn.close()
        assert os.path.basename(argv[1].rstrip("/")) in models
        choice = reply["choices"][0]
        assert isinstance(choice["message"]["content"], str)
        assert choice["finish_reason"] in ("stop", "length")
        # the directory's BPE tokenizer is on the path
        from gabby_tpu_torch.tokenizer import ChatFormat, Tokenizer
        bpe = Tokenizer.from_file(os.path.join(out, "tokenizer.json"))
        want = len(ChatFormat(bpe).prompt_ids(CHAT["messages"]))
        assert reply["usage"]["prompt_tokens"] == want
        assert want < len(ChatFormat(Tokenizer.byte_fallback(1024))
                          .prompt_ids(CHAT["messages"]))
        assert 0 < reply["usage"]["completion_tokens"] <= 5


def test_model_dir_without_tokenizer_is_refused(quantized_dir, tmp_path):
    from gabby_tpu_torch import server
    _, out = quantized_dir
    bare = tmp_path / "bare"
    shutil.copytree(out, bare)
    (bare / "tokenizer.json").unlink()
    with pytest.raises(SystemExit, match="tokenizer.json"):
        server._build_engine(server.build_parser().parse_args(
            ["--model-dir", str(bare), "--device", "cpu"]))


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


def test_chat_completion_roundtrip(port):
    status, body = _post(port, CHAT)
    assert status == 200, body
    out = json.loads(body)
    assert out["object"] == "chat.completion"
    choice = out["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert choice["finish_reason"] in ("stop", "length")
    assert 0 < out["usage"]["prompt_tokens"]
    assert out["usage"]["completion_tokens"] <= 5


@pytest.mark.parametrize("flags", [
    ["--speculate", "4"],
    ["--paged-pages", "33", "--page-size", "16", "--max-seq", "256"],
    ["--speculate", "4", "--paged-pages", "33", "--page-size", "16",
     "--max-seq", "256", "--spec-breakeven", "1.0",
     "--spec-reprobe-steps", "64"],
], ids=["speculate", "paged", "paged-speculate"])
def test_speculate_and_paged_flags_serve(flags):
    with _serving(["--preset", "tiny", "--random-weights"] + flags) as p:
        status, body = _post(p, CHAT)
        assert status == 200, body
        reply = json.loads(body)
        assert reply["choices"][0]["finish_reason"] in ("stop", "length")
        assert 0 < reply["usage"]["completion_tokens"] <= 5
        conn = http.client.HTTPConnection("127.0.0.1", p, timeout=120)
        conn.request("GET", "/statusz")
        stats = json.loads(conn.getresponse().read())["engine"]
        conn.close()
        assert stats["spec_on"] == int("--speculate" in flags)
        assert (stats["spec_macro_steps"] > 0) == ("--speculate" in flags)


def test_ported_flags_reach_the_engine_config():
    from gabby_tpu_torch import server
    args = server.build_parser().parse_args(
        ["--preset", "tiny", "--random-weights", "--device", "cpu",
         "--max-seq", "256", "--speculate", "3", "--spec-breakeven", "1.5",
         "--spec-reprobe-steps", "99", "--paged-pages", "33",
         "--page-size", "16"])
    engine, _ = server._build_engine(args)
    try:
        ec = engine.ec
        assert (ec.speculate_tokens, ec.spec_breakeven,
                ec.spec_reprobe_steps, ec.paged_pages, ec.page_size) == (
                    3, 1.5, 99, 33, 16)
    finally:
        engine.shutdown()


@pytest.mark.parametrize("flags,paired", [
    ([], True), (["--no-pair-kv"], False), (["--pair-kv"], True),
    (["--paged-pages", "33", "--page-size", "16", "--max-seq", "256"], True),
    (["--no-pair-kv", "--paged-pages", "33", "--page-size", "16",
      "--max-seq", "256"], False),
], ids=["auto", "no-pair-kv", "pair-kv", "auto-paged", "no-pair-kv-paged"])
def test_pair_kv_flag_follows_the_reference_auto_rule(flags, paired):
    """`--pair-kv` defaults to auto (gabby_tpu/server.py:140-142): the
    paired cache whenever the kv-head count is even, dense and paged;
    `--no-pair-kv` reverts. The tiny preset has 2 kv heads."""
    from gabby_tpu_torch import server
    from gabby_tpu_torch.runtime.kv_cache import cache_is_paired
    args = server.build_parser().parse_args(
        ["--preset", "tiny", "--random-weights", "--device", "cpu",
         "--kv-quant"] + flags)
    engine, cfg = server._build_engine(args)
    try:
        assert engine.ec.pair_kv_heads is paired
        assert cache_is_paired(engine._cache, cfg) is paired
        assert engine._cache.k_scale.shape[2] == cfg.num_kv_heads
    finally:
        engine.shutdown()


@pytest.mark.parametrize("flags,paired", [([], False), (["--pair-kv"], None)],
                         ids=["auto", "pair-kv"])
def test_pair_kv_with_an_odd_kv_head_count(monkeypatch, flags, paired):
    """An odd kv-head count: auto leaves pairing off, and an explicit
    `--pair-kv` is refused with the reference's message."""
    from gabby_tpu_torch import config as cfglib
    from gabby_tpu_torch import server
    tiny = cfglib.tiny
    monkeypatch.setattr(cfglib, "tiny",
                        lambda **kw: tiny(num_kv_heads=1, **kw))
    args = server.build_parser().parse_args(
        ["--preset", "tiny", "--random-weights", "--device", "cpu"] + flags)
    if paired is None:
        with pytest.raises(SystemExit,
                           match="pair_kv_heads needs an even kv-head count"):
            server._build_engine(args)
        return
    engine, _ = server._build_engine(args)
    try:
        assert engine.ec.pair_kv_heads is paired
    finally:
        engine.shutdown()


def test_default_server_decodes_with_the_s8_form(monkeypatch):
    """The default command line serves as the reference's does: paired
    cache, s8 decode attention; GABBY_ATTN_S8=0 restores the bf16/f32
    form."""
    from gabby_tpu_torch.ops import cuda as ck
    from gabby_tpu_torch.ops.cuda import attention as cattn
    calls = []
    for name in ("decode_attention_s8", "decode_attention"):
        real = getattr(cattn, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, a[1].shape[-1]))
            return _real(*a, **k)

        monkeypatch.setattr(cattn, name, spy)
    monkeypatch.delenv("GABBY_ATTN_S8", raising=False)
    ck.set_attn_s8(None)
    with _serving(["--preset", "tiny", "--random-weights"]) as p:
        assert _post(p, CHAT)[0] == 200
        # lanes 32 = 2 * head_dim of the tiny preset: the paired cache
        assert calls and set(calls) == {("decode_attention_s8", 32)}
        calls.clear()
        monkeypatch.setenv("GABBY_ATTN_S8", "0")
        assert _post(p, CHAT)[0] == 200
        assert calls and set(calls) == {("decode_attention", 32)}


@pytest.mark.parametrize("flag", [["--profiler-port", "9999"]])
def test_profiler_port_flag_builds_its_engine(flag):
    """--profiler-port, the last of the reference's flags to be ported, is
    accepted: the tiny CPU engine builds with it set (the capture endpoint
    itself: tests/test_torch_profiler.py)."""
    from gabby_tpu_torch import server
    args = server.build_parser().parse_args(
        ["--preset", "tiny", "--random-weights", "--device", "cpu"] + flag)
    assert args.profiler_port == 9999
    engine, _ = server._build_engine(args)
    try:
        assert engine.capturer is None  # attached by the serving loop
    finally:
        engine.shutdown()


def test_every_flag_of_the_reference_is_ported():
    """No flag is refused any more: the refusal mechanism is gone, and
    --profiler-port 0 (the default) starts no capture endpoint."""
    from gabby_tpu_torch import server
    assert not hasattr(server, "_NOT_PORTED")
    assert server._start_profiler(server.build_parser().parse_args([])) \
        is None


@pytest.mark.parametrize("flag", ["--act-fp8", "--prefill-int8-shadow",
                                  "--pipeline-fetch"])
def test_ported_flags_build_their_engine(flag):
    """Each of the reference's three single-card options builds the tiny
    int4 CPU engine with the option on, and a request is served."""
    from gabby_tpu_torch import server
    from gabby_tpu_torch.ops import quant
    args = server.build_parser().parse_args(
        ["--preset", "tiny", "--random-weights", "--device", "cpu",
         "--quant", "4", "--kv-quant", flag])
    engine, was = None, quant.act_fp8_enabled()
    try:
        engine, _ = server._build_engine(args)
        if flag == "--act-fp8":
            assert quant.act_fp8_enabled()
        elif flag == "--prefill-int8-shadow":
            shadow = engine._prefill_params["blocks"]["wqkv"]
            assert shadow.bits == 8
            assert shadow.scale is engine.params["blocks"]["wqkv"].scale
            assert engine.params["blocks"]["wqkv"].bits == 4
        else:
            assert engine._pipeline
        _, fin, _, n = engine.generate_sync(
            [{"role": "user", "content": "hi"}], max_tokens=3)
        assert fin in ("stop", "length") and n >= 1
    finally:
        if engine is not None:
            engine.shutdown()
        quant.set_act_fp8(was)
