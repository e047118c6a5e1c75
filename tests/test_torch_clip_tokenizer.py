"""The port's CLIP tokenizer and text fixer held against the JAX package's.

``quantize_tpu_torch/models/clip/{textfix,tokenizer}.py`` are copies (the
port imports nothing of ``quantize_tpu``); here every case of
``tests/test_textfix.py``, ``tests/test_bpe_tokenizer.py`` (a merges file
built in the test) and ``tests/test_clip.py``'s tokenizer cases goes
through both, and the texts, token lists and ``int32`` token grids must be
identical.
"""
import numpy as np
import pytest

from quantize_tpu.models.clip import class_prompt_tokens as jax_class_prompt_tokens
from quantize_tpu.models.clip import textfix as jax_textfix
from quantize_tpu.models.clip import tokenizer as jax_tokenizer
from quantize_tpu_torch.models.clip import class_prompt_tokens, textfix, tokenizer

TEXTFIX_CASES = [
    ("caffÃ¨ macchiato", "caffè macchiato"),
    ("naÃ¯ve", "naïve"),
    ("SÃ£o Paulo", "São Paulo"),
    ("Ã©lÃ¨ve", "élève"),
    ("â€œquotedâ€\x9d", '"quoted"'),
    ("donâ€™t", "don't"),
    ("caffè".encode("utf-8").decode("latin-1").encode("utf-8").decode("latin-1"), "caffè"),
    ("plain ascii", "plain ascii"),
    ("déjà vu", "déjà vu"),
    ("München", "München"),
    ("日本語のテキスト", "日本語のテキスト"),
    ("emoji 😀 stays", "emoji 😀 stays"),
    ("ﬁsh ﬂy ﬀ", "fish fly ff"),
    ("ﬅop ﬆop", "ſtop stop"),
    ("ＡＢＣ１２３", "ABC123"),
    ("E=mc²", "E=mc²"),
    ("½ cup", "½ cup"),
    ("it’s “fine”", "it's \"fine\""),
    ("x\x1b[31mred\x1b[0m", "xred"),
    ("a\rb\r\nc\u2028d", "a\nb\nc\nd"),
    ("nul\x00l bel\x07l", "null bell"),
    ("\ud83d\ude00", "😀"),  # the surrogate pair of U+1F600
]


@pytest.mark.parametrize("src,want", TEXTFIX_CASES)
def test_fix_text_matches_jax(src, want):
    assert textfix.fix_text(src) == jax_textfix.fix_text(src) == want
    assert textfix.fix_encoding(src) == jax_textfix.fix_encoding(src)


@pytest.mark.parametrize("text", ["a photo of a caffÃ¨, naÃ¯ve style.", "&amp;amp; x",
                                  "  a\tphoto\n of "])
def test_cleaning_matches_jax(text):
    assert tokenizer.basic_clean(text) == jax_tokenizer.basic_clean(text)
    assert (tokenizer.whitespace_clean(tokenizer.basic_clean(text))
            == jax_tokenizer.whitespace_clean(jax_tokenizer.basic_clean(text)))


def test_bytes_to_unicode_matches_jax():
    mine, theirs = tokenizer.bytes_to_unicode(), jax_tokenizer.bytes_to_unicode()
    assert mine == theirs and len(set(mine.values())) == 256


MERGES = ["l o", "lo w", "e r</w>"]
TEXTS = ["lower", "lowest", "a", "erg", "LOWER   isn't", "lower lowest", "é",
         "a photo of a caffè.", "a photo of a caffÃ¨.", "lower " * 100]


@pytest.fixture(scope="module")
def bpe_pair(tmp_path_factory):
    p = tmp_path_factory.mktemp("bpe") / "merges.txt"
    p.write_text("#version: 0.2 (synthetic test vocab)\n" + "\n".join(MERGES) + "\n")
    return tokenizer.BPETokenizer(str(p)), jax_tokenizer.BPETokenizer(str(p))


def test_bpe_vocab_matches_jax(bpe_pair):
    mine, theirs = bpe_pair
    assert mine.encoder == theirs.encoder and mine.bpe_ranks == theirs.bpe_ranks
    assert (mine.vocab_size, mine.sot_token, mine.eot_token) == (
        theirs.vocab_size, theirs.sot_token, theirs.eot_token) == (517, 515, 516)


@pytest.mark.parametrize("text", TEXTS)
def test_bpe_encode_and_tokenize_match_jax(bpe_pair, text):
    mine, theirs = bpe_pair
    ids = mine.encode(text)
    assert ids == theirs.encode(text)
    assert mine.decode(ids) == theirs.decode(ids)
    for length in (77, 8):
        grid = tokenizer.tokenize([text], tokenizer=mine, context_length=length)
        want = jax_tokenizer.tokenize([text], tokenizer=theirs, context_length=length)
        assert grid.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(grid, want)
        row = grid[0]
        assert row[0] == mine.sot_token and mine.eot_token in row


def test_bpe_missing_vocab_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="CLIP_BPE_PATH"):
        tokenizer.BPETokenizer(str(tmp_path / "absent.txt.gz"))


def test_bpe_reads_the_merges_file_from_the_environment(bpe_pair, monkeypatch, tmp_path):
    import gzip

    p = tmp_path / "bpe_simple_vocab.txt.gz"
    with gzip.open(p, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setenv("CLIP_BPE_PATH", str(p))
    tok = tokenizer.BPETokenizer()
    assert tok.encode("lower lowest") == bpe_pair[0].encode("lower lowest")


@pytest.mark.parametrize("vocab", [64, 1024, 49408])
def test_hash_tokenizer_grids_match_jax(vocab):
    texts = ["a photo of a cat.", "a photo of a caffÃ¨.", "A  BAD photo of the dog", ""]
    mine = tokenizer.tokenize(texts, tokenizer=tokenizer.HashTokenizer(vocab), context_length=16)
    want = jax_tokenizer.tokenize(texts, tokenizer=jax_tokenizer.HashTokenizer(vocab),
                                  context_length=16)
    assert mine.dtype == np.int32 and mine.shape == (4, 16)
    np.testing.assert_array_equal(mine, want)
    assert (mine[:, 0] == vocab - 2).all()
    assert (mine.max(axis=1) == vocab - 1).all()  # EOT is the highest id


def test_class_prompt_tokens_match_jax(bpe_pair):
    prompts = ["a photo of a {}.", "a {}"]
    for mine_tok, their_tok in ((bpe_pair[0], bpe_pair[1]),
                                (tokenizer.HashTokenizer(64), jax_tokenizer.HashTokenizer(64))):
        mine = class_prompt_tokens(["lower", "lowest", "cat"], prompts, mine_tok, 16)
        want = jax_class_prompt_tokens(["lower", "lowest", "cat"], prompts, their_tok, 16)
        assert mine.shape == (3, 2, 16)
        np.testing.assert_array_equal(mine, want)


def test_default_tokenizer_is_the_hash_stand_in_without_a_vocab(monkeypatch):
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.setattr(tokenizer, "_default_tokenizer", None)
    tok = tokenizer.get_default_tokenizer()
    assert isinstance(tok, tokenizer.HashTokenizer) and tok.vocab_size == 1024
