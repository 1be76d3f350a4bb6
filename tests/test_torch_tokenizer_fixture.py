"""The port's tokenizer (gabby_tpu_torch.tokenizer) against the RECORDED
HuggingFace `tokenizers` goldens of the committed multilingual fixture, as
tests/test_tokenizer_fixture.py holds the reference's: every golden's
encode and decode, each a case of its own, and the non-ASCII round trips.
The port's copy differs from the reference's in how it imports `regex`
and splits added tokens, so it is held to the same goldens on its own."""

import json
import os

import pytest

from gabby_tpu_torch.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures",
                       "multilingual_tokenizer.json")
with open(os.path.join(REPO, "tests", "fixtures", "tokenizer_goldens.json"),
          encoding="utf-8") as _f:
    GOLDENS = json.load(_f)["goldens"]


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_file(FIXTURE)


@pytest.mark.parametrize("i", range(len(GOLDENS)))
def test_encode_matches_hf_golden(tok, i):
    g = GOLDENS[i]
    assert tok.encode(g["text"]) == g["ids"], g["text"]


@pytest.mark.parametrize("i", range(len(GOLDENS)))
def test_decode_matches_hf_golden(tok, i):
    g = GOLDENS[i]
    assert tok.decode(g["ids"]) == g["decoded"], g["text"]


@pytest.mark.parametrize("text", [
    "héllo wörld — ¡sí! ٣٤٥ 😀", "日本語とEnglishの混在",
    "tab\tand nbsp\u00a0and ideographic\u3000space"])
def test_roundtrip_nonascii(tok, text):
    assert tok.decode(tok.encode(text)) == text
