"""Model-asset loading: HF model dir -> (ModelConfig, params dict, Tokenizer)
(counterpart of gabby_tpu/loader.py).

A .safetensors file is an 8-byte header length, a JSON header of
dtype/shape/offset triples, then the tensors' bytes. The header's triples
become zero-copy torch views over a memmap (bf16 is read as 16-bit words
and viewed as `torch.bfloat16`: numpy has no such type), which are
transposed, optionally quantized per layer on the target device — so an
INT4/INT8 checkpoint never materializes in bf16 there — and stacked.

The files are the reference's, byte for byte: `write_safetensors` of the
same arrays gives the same file in either package, and a `gabby-quant`
directory written by `save_quantized` here loads there and the reverse.
`device_put_fn(path, leaf)` places each leaf as it is read (tensor
parallelism: parallel.sharding.sharded_put_fn slices it to the rank's
block first, so a checkpoint never lands whole on a card); by default
tensors land on the device the caller names.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Any, Optional

import numpy as np
import torch

from gabby_tpu_torch import resolve_device
from gabby_tpu_torch.config import ModelConfig, RopeScaling
from gabby_tpu_torch.ops import quant

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TO_SFT = {v: k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Parse one .safetensors file into name -> CPU tensors that are
    zero-copy views of a (copy-on-write) memmap of the file, where the
    file aligns them."""
    with open(path, "rb") as f:
        header_len = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(header_len))
    data_start = 8 + header_len
    if os.path.getsize(path) == data_start:  # nothing but empty tensors
        data = torch.empty(0, dtype=torch.uint8)
    else:
        data = torch.from_numpy(np.memmap(path, dtype=np.uint8, mode="c",
                                          offset=data_start))
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        raw = data[begin:end]
        if begin % dtype.itemsize or (data_start + begin) % dtype.itemsize:
            raw = raw.clone()  # misaligned in the file: one aligned copy
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def _as_tensor(a) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.detach().cpu().contiguous()


def write_safetensors(path: str, tensors: dict[str, Any]) -> None:
    """Write name -> tensor (torch, any device, or numpy) as one file."""
    header: dict[str, Any] = {}
    offset = 0
    blobs = []
    for name, a in tensors.items():
        t = _as_tensor(a)
        nbytes = t.numel() * t.element_size()
        blobs.append(t)
        header[name] = {
            "dtype": _TO_SFT[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def read_model_tensors(model_dir: str) -> dict[str, torch.Tensor]:
    """Single- or multi-shard (index.json) safetensors directory."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
        tensors: dict[str, torch.Tensor] = {}
        for fname in sorted(set(weight_map.values())):
            tensors.update(read_safetensors(os.path.join(model_dir, fname)))
        return tensors
    return read_safetensors(os.path.join(model_dir, "model.safetensors"))


def _stack_q(qs: list) -> Any:
    if isinstance(qs[0], quant.QTensor):
        return quant.QTensor(q=torch.stack([t.q for t in qs]),
                             scale=torch.stack([t.scale for t in qs]),
                             bits=qs[0].bits)
    return torch.stack(qs)


def load_llama_params(model_dir: str, cfg: ModelConfig, *,
                      dtype=torch.bfloat16, quant_bits: Optional[int] = None,
                      device=None, device_put_fn=None) -> dict:
    """HF Llama checkpoint -> our stacked params dict on `device`.

    HF nn.Linear weights are [out, in]; ours are [in, out] (x @ w), so each
    projection is transposed once. With `quant_bits` each layer's weight is
    quantized on the device before it is stacked. `device_put_fn(path,
    leaf)` places every leaf, and every layer of a projection before it is
    stacked (default: a move to `device`)."""
    dev = resolve_device(device)
    t = read_model_tensors(model_dir)
    place = device_put_fn or (lambda path, leaf: leaf.to(dev))

    def put(path: tuple, a: torch.Tensor) -> torch.Tensor:
        return place(path, a).to(dtype)

    def proj(ours: str, name: str, layer: int):
        w = t[f"model.layers.{layer}.{name}.weight"]
        if quant_bits is None:
            return put(("blocks", ours), w.T).contiguous()
        # a row shard's scales need the whole input dim: quantize the
        # layer whole on the device, then place it
        return place(("blocks", ours),
                     quant.quantize(w.to(dev).T.contiguous(), quant_bits))

    names = {
        "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
        "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
        "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
        "w_down": "mlp.down_proj",
    }
    blocks: dict[str, Any] = {}
    for ours, hf in names.items():
        blocks[ours] = _stack_q([proj(ours, hf, layer)
                                 for layer in range(cfg.num_layers)])
    for ours, hf in (("attn_norm", "input_layernorm"),
                     ("mlp_norm", "post_attention_layernorm")):
        blocks[ours] = torch.stack([
            put(("blocks", ours), t[f"model.layers.{layer}.{hf}.weight"])
            for layer in range(cfg.num_layers)])

    params: dict[str, Any] = {
        "embed": put(("embed",), t["model.embed_tokens.weight"]),
        "blocks": blocks,
        "final_norm": put(("final_norm",), t["model.norm.weight"]),
        "lm_head": None,
    }
    # the unembed is THE largest weight stream of a decode step: a
    # quantized serve gives it its own quantized [D, V] table (int8 per
    # vocab channel by default, int4 + group scales with
    # GABBY_UNEMBED_BITS=4) whether the checkpoint ties it to the
    # embedding or not
    if not cfg.tie_word_embeddings:
        head = t["lm_head.weight"].to(dev).T.contiguous()
        params["lm_head"] = place(("lm_head",), (
            quant.quantize_unembed_table(head) if quant_bits
            else head.to(dtype)))
    elif quant_bits:
        params["lm_head"] = place(("lm_head",), quant.quantize_unembed_table(
            t["model.embed_tokens.weight"].to(dev).T.contiguous()))
    return params


# ---- pre-quantized checkpoints (quantize once, serve many times) -------

GABBY_META = "gabby.json"


def _flatten_params(params: dict, prefix: str = ""
                    ) -> tuple[dict[str, torch.Tensor], dict[str, list]]:
    """Params dict -> (flat tensors, per-QTensor [bits, group]).
    QTensor leaves become <name>.q / <name>.scale."""
    flat: dict[str, torch.Tensor] = {}
    qbits: dict[str, list] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if v is None:
            continue
        if isinstance(v, dict):
            sub, subbits = _flatten_params(v, name + ".")
            flat.update(sub)
            qbits.update(subbits)
        elif isinstance(v, quant.QTensor):
            flat[name + ".q"] = v.q
            flat[name + ".scale"] = v.scale
            qbits[name] = [v.bits, v.group]
        else:
            flat[name] = v
    return flat, qbits


def save_quantized(out_dir: str, cfg: ModelConfig, params: dict,
                   bits: int, *, src_dir: Optional[str] = None) -> None:
    """Writes a pre-quantized checkpoint: the params dict flattened into
    one safetensors file + gabby.json metadata; tokenizer/config JSONs are
    copied from src_dir when given so the directory serves standalone."""
    os.makedirs(out_dir, exist_ok=True)
    flat, qbits = _flatten_params(params)
    write_safetensors(os.path.join(out_dir, "model.safetensors"), flat)
    config = {k: v for k, v in cfg.__dict__.items() if k != "rope_scaling"}
    with open(os.path.join(out_dir, GABBY_META), "w") as f:
        json.dump({"format": "gabby-quant", "bits": bits, "qbits": qbits,
                   # int4 nibble pairing of quant.pack_int4; loaders
                   # reject mismatched checkpoints instead of silently
                   # decoding garbage weights
                   "int4_packing": "halfsplit",
                   "config": config,
                   "rope_scaling": (cfg.rope_scaling.__dict__
                                    if cfg.rope_scaling else None)}, f)
    if src_dir:
        for name in ("config.json", "generation_config.json",
                     "tokenizer.json", "tokenizer_config.json",
                     "special_tokens_map.json"):
            src = os.path.join(src_dir, name)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, name))


def load_quantized(model_dir: str, *, max_seq_len: Optional[int] = None,
                   dtype=torch.bfloat16, device=None, tp: int = 1,
                   device_put_fn=None):
    """Loads a save_quantized() directory for a run over `tp` ranks (each
    leaf placed by `device_put_fn(path, leaf)`, default a move to
    `device`). Returns (cfg, params, bits)."""
    dev = resolve_device(device)
    place = device_put_fn or (lambda path, leaf: leaf.to(dev))
    with open(os.path.join(model_dir, GABBY_META)) as f:
        meta = json.load(f)
    if meta.get("format") != "gabby-quant":
        raise ValueError(f"{model_dir}: not a gabby checkpoint")
    # qbits values: [bits, group] (current) or bare int bits (older files)
    qbits: dict = {k: (v if isinstance(v, (list, tuple)) else (v, 0))
                   for k, v in meta.get("qbits", {}).items()}
    has_int4 = (any(bg[0] == 4 for bg in qbits.values())
                or meta.get("bits") == 4)
    if has_int4:
        packing = meta.get("int4_packing", "interleaved")
        if packing != "halfsplit":
            raise ValueError(
                f"checkpoint uses int4 packing '{packing}' but this build "
                f"reads 'halfsplit' — re-run tools/quantize.py from the "
                f"original weights")
    cfg_kv = dict(meta["config"])
    fused_tp = cfg_kv.setdefault("fused_tp", 1)
    fused = any(name.endswith(("wqkv", "w_gup")) for name in qbits)
    if fused_tp != tp and (fused_tp != 1 or fused):
        # fused columns are laid out per shard of fused_tp ranks; an
        # unfused tree (fused_tp 1) shards over any tp
        raise ValueError(
            f"checkpoint was fused for tp={fused_tp} (its fused_tp) but "
            f"this run has tp={tp}: re-fuse it with fuse_projections(params, "
            f"tp={tp})")
    cfg_kv["rope_scaling"] = (RopeScaling(**meta["rope_scaling"])
                              if meta.get("rope_scaling") else None)
    cfg_kv["eos_token_ids"] = tuple(cfg_kv.get("eos_token_ids", ()))
    if max_seq_len is not None:
        cfg_kv["max_seq_len"] = max_seq_len
    cfg = ModelConfig(**cfg_kv)

    flat = read_safetensors(os.path.join(model_dir, "model.safetensors"))
    params: dict[str, Any] = {}
    for name in sorted(set(n[:-2] if n.endswith(".q") else
                           n[:-6] if n.endswith(".scale") else n
                           for n in flat)):
        parts = name.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if name in qbits:
            bits, group = qbits[name]
            leaf = quant.QTensor(q=flat[name + ".q"],
                                 scale=flat[name + ".scale"],
                                 bits=int(bits), group=int(group))
        else:
            leaf = flat[name]
            if leaf.is_floating_point():
                leaf = leaf.to(dtype)
        node[parts[-1]] = place(tuple(parts), leaf)
    params.setdefault("lm_head", None)
    return cfg, params, int(meta["bits"])


def load_model_dir(model_dir: str, *, dtype=torch.bfloat16,
                   quant_bits: Optional[int] = None,
                   max_seq_len: Optional[int] = None, device=None,
                   tp: int = 1, device_put_fn=None):
    """Load the five HF JSONs + weights onto `device` (each leaf placed by
    `device_put_fn` when given). Directories written by save_quantized()
    load directly (quant_bits then comes from the checkpoint's own
    metadata; its fused_tp must suit `tp`, see load_quantized).

    Returns (cfg, params, tokenizer | None).
    """
    from gabby_tpu_torch.tokenizer import Tokenizer

    device = resolve_device(device)  # refuse before any file is read
    tok_path = os.path.join(model_dir, "tokenizer.json")

    def tokenizer():
        return Tokenizer.from_file(tok_path) if os.path.exists(tok_path) \
            else None

    if os.path.exists(os.path.join(model_dir, GABBY_META)):
        cfg, params, _bits = load_quantized(
            model_dir, max_seq_len=max_seq_len, dtype=dtype, device=device,
            tp=tp, device_put_fn=device_put_fn)
        return cfg, params, tokenizer()

    overrides: dict[str, Any] = {}
    if max_seq_len is not None:
        overrides["max_seq_len"] = max_seq_len
    cfg = ModelConfig.from_json_file(
        os.path.join(model_dir, "config.json"), **overrides)

    gen_cfg_path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(gen_cfg_path):
        with open(gen_cfg_path) as f:
            gen = json.load(f)
        eos = gen.get("eos_token_id", list(cfg.eos_token_ids))
        eos = tuple(eos) if isinstance(eos, list) else (eos,)
        cfg = ModelConfig(**{**cfg.__dict__, "eos_token_ids": eos,
                             "bos_token_id": gen.get("bos_token_id",
                                                     cfg.bos_token_id)})

    params = load_llama_params(model_dir, cfg, dtype=dtype,
                               quant_bits=quant_bits, device=device,
                               device_put_fn=device_put_fn)
    return cfg, params, tokenizer()
