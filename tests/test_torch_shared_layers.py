"""The port's own copies of ``vlm_tpu``'s framework-free layers (configs,
tokenizers and the byte-level BPE reader, label parsers, datasets,
evaluator, ``run_zero_shot``) against
the originals on the CPU: the same values, ids, labels and artifacts.

The port imports nothing of ``vlm_tpu``; only this test imports both.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import sklearn.metrics
from test_sentencepiece import _unigram_model, build_model

from vlm_tpu.data import bpe as j_bpe
from vlm_tpu.data import parsers as j_parsers
from vlm_tpu.data.dataset_factory import DatasetFactory as JFactory
from vlm_tpu.data.sentencepiece import BYTE
from vlm_tpu.data.tokenizer import ByteTokenizer as JByte
from vlm_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer
from vlm_tpu.evaluation import Evaluator as JEvaluator
from vlm_tpu.evaluation import run_zero_shot as j_run_zero_shot
from vlm_tpu.models import configs as j_configs
from vlm_tpu_torch.data import bpe as t_bpe
from vlm_tpu_torch.data import parsers as t_parsers
from vlm_tpu_torch.data.dataset_factory import DatasetFactory as TFactory
from vlm_tpu_torch.data.tokenizer import ByteTokenizer as TByte
from vlm_tpu_torch.data.tokenizer import SPTokenizer as TSP
from vlm_tpu_torch.data.tokenizer import load_tokenizer as t_load_tokenizer
from vlm_tpu_torch.evaluation import Evaluator as TEvaluator
from vlm_tpu_torch.evaluation import evaluator as t_evaluator
from vlm_tpu_torch.evaluation import run_zero_shot as t_run_zero_shot
from vlm_tpu_torch.models import configs as t_configs
from vlm_tpu_torch.models.factory import create_model

SIZES = {"llava": "7b", "paligemma": "3b", "blip2": "6.7b"}


@pytest.mark.parametrize("family", sorted(SIZES))
@pytest.mark.parametrize("size", ["full", "test"])
def test_configs_equal(family, size):
    s = SIZES[family] if size == "full" else "test"
    assert dataclasses.asdict(t_configs.VLM_CONFIGS[family](s)) == \
        dataclasses.asdict(j_configs.VLM_CONFIGS[family](s))
    assert sorted(t_configs.VLM_CONFIGS) == sorted(j_configs.VLM_CONFIGS)


TEXTS = ["hello world", "  hello   world ", "word", "hello¢", "",
         "Gender: female, 34.5, east asian, happiness\n"]


@pytest.mark.parametrize("text", TEXTS)
def test_byte_tokenizer_same_ids_and_text(text):
    for add_bos in (False, True):
        ids = TByte().encode(text, add_bos=add_bos)
        assert ids == JByte().encode(text, add_bos=add_bos)
        assert TByte().decode(ids) == JByte().decode(ids)
    # the fallback the models use: no tokenizer files
    tok, ref = (f(None, bos_id=2, eos_id=1, pad_id=0)
                for f in (t_load_tokenizer, j_load_tokenizer))
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == \
        (ref.bos_id, ref.eos_id, ref.pad_id)
    assert tok.encode(text, add_bos=True) == ref.encode(text, add_bos=True)


def _byte_fallback_model():
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
              ("▁", -3.0), ("▁hi", -1.0)] + \
        [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    return build_model(pieces, byte_fallback=True)


@pytest.mark.parametrize("model", ["unigram", "byte_fallback"])
def test_sentencepiece_reader_same_ids_and_text(model, tmp_path):
    data = _unigram_model() if model == "unigram" else _byte_fallback_model()
    (tmp_path / "tokenizer.model").write_bytes(data)
    tok = t_load_tokenizer(str(tmp_path))
    ref = j_load_tokenizer(str(tmp_path))
    assert isinstance(tok, TSP)
    for text in TEXTS + ["hi¢ hi", "hello hi"]:
        ids = tok.encode(text, add_bos=True)
        assert ids == ref.encode(text, add_bos=True)
        assert tok.decode(ids) == ref.decode(ids)


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    """The byte-level BPE ``tests/test_bpe.py`` trains with the tokenizers
    library (its corpus, vocabulary of 512 and specials), saved as
    ``tokenizer.json`` and as ``vocab.json`` + ``merges.txt`` with an
    OPT-style ``tokenizer_config.json`` (BOS = EOS = ``</s>``)."""
    tokenizers = pytest.importorskip("tokenizers")
    from test_bpe import CORPUS
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=512, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    d = tmp_path_factory.mktemp("bpe")
    tok.save(str(d / "tokenizer.json"))
    pair_dir = d / "pair"
    pair_dir.mkdir()
    tok.model.save(str(pair_dir))
    (pair_dir / "tokenizer_config.json").write_text(json.dumps({
        "bos_token": "</s>", "eos_token": "</s>",
        "pad_token": "<pad>", "unk_token": "</s>"}))
    return d


BPE_TEXTS = TEXTS + [
    "Question: what colors are the upper and lower clothes. Answer:",
    "I'm sure they're right, isn't it? We've 99 problems.",
    "unicode: naïve café 東京 ¡hola! ∑x²=π", "tabs\tand\nnewlines\r\n x",
    "</s>Question: hi. Answer:"]


@pytest.mark.parametrize("fmt", ["pair", "tokenizer.json"])
def test_bpe_reader_same_ids_and_text(bpe_files, fmt):
    """The port's copy of the reader gives vlm_tpu's ids, OPT-style
    special ids and text on the same files."""
    load = {"pair": "load_bpe_dir", "tokenizer.json": "load_tokenizer_json"}
    tok, ref = (getattr(mod, load[fmt])(str(bpe_files / fmt))
                for mod in (t_bpe, j_bpe))
    assert (tok.bos_id, tok.eos_id, tok.pad_id) == \
        (ref.bos_id, ref.eos_id, ref.pad_id)
    if fmt == "pair":
        assert tok.bos_id == tok.eos_id != tok.pad_id
    for text in BPE_TEXTS:
        for add_bos in (False, True):
            ids = tok.encode(text, add_bos=add_bos)
            assert ids == ref.encode(text, add_bos=add_bos)
            assert tok.decode(ids) == ref.decode(ids)
    assert t_bpe.bytes_to_unicode() == j_bpe.bytes_to_unicode()
    for text in BPE_TEXTS:
        assert t_bpe._pretokenize_fallback(text) == \
            j_bpe._pretokenize_fallback(text) == j_bpe.pretokenize(text)


@pytest.mark.parametrize("fmt", ["pair", "tokenizer.json"])
def test_load_tokenizer_reads_bpe_files(bpe_files, fmt, monkeypatch):
    """``load_tokenizer`` without transformers (its HF branch refused) takes
    the BPE branch in both packages, from a directory and from a
    ``tokenizer.json`` path, and through ``VLM_TPU_TOKENIZER``."""
    import vlm_tpu.data.tokenizer as j_tk
    import vlm_tpu_torch.data.tokenizer as t_tk

    def refuse(path):
        raise ImportError("transformers absent")
    for mod in (t_tk, j_tk):
        monkeypatch.setattr(mod, "HFTokenizer", refuse)
    monkeypatch.setenv("VLM_TPU_TOKENIZER", str(bpe_files / fmt))
    tok, ref = t_load_tokenizer(None), j_load_tokenizer(None)
    assert isinstance(tok, t_bpe.ByteLevelBPE)
    assert isinstance(ref, j_bpe.ByteLevelBPE)
    for text in BPE_TEXTS:
        assert tok.encode(text, add_bos=True) == ref.encode(text, add_bos=True)


FACE_ANSWERS = [
    "Male, 27.5, Asian Indian, Happiness", "female, 30, caucasian, neutral",
    "Male, 30, caucasian, neutral", "male, 27.5, caucasian, neutral",
    "male, 30, asian, neutral", "male, 30, indian asian person, surprise",
    "male, 30, african american, full of happiness", "male, 75, martian, x",
    "male, 1.5, caucasian latin, neutral expression", "male, nan, ?, bored",
    "male, 30", "garbage", "", "female, 9, east asian, anger"]
MIVIA_ANSWERS = [
    "Black, Blue, Male, No, Yes", "dark red, purple, male, no, no",
    "black, white, male, yes., no bag", "black, white, male",
    "chartreuse, black, male, no, no", "dark, dark gray, female, yes, no",
    "red, yellow, female, maybe, unknown", "garbage", ""]


@pytest.mark.parametrize("answer", FACE_ANSWERS)
@pytest.mark.parametrize("regression", [False, True])
def test_face_parser_same_labels(answer, regression):
    got = t_parsers.parse_face_output(answer, age_is_regression=regression,
                                      rng=random.Random(0))
    want = j_parsers.parse_face_output(answer, age_is_regression=regression,
                                       rng=random.Random(0))
    # through JSON, as the evaluator writes them (an age of nan included)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("answer", MIVIA_ANSWERS)
def test_mivia_parser_same_labels(answer):
    assert t_parsers.parse_mivia_par_output(answer) == \
        j_parsers.parse_mivia_par_output(answer)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    t = [int(x) for x in rng.integers(0, 5, 40)]
    p = [int(x) for x in rng.integers(0, 6, 40)]
    assert t_evaluator.accuracy_score(t, p) == \
        sklearn.metrics.accuracy_score(t, p)
    np.testing.assert_array_equal(t_evaluator.confusion_matrix(t, p),
                                  sklearn.metrics.confusion_matrix(t, p))
    labels = list(range(4))
    np.testing.assert_array_equal(
        t_evaluator.confusion_matrix(t, p, labels=labels),
        sklearn.metrics.confusion_matrix(t, p, labels=labels))
    tf = [float(x) for x in rng.uniform(0, 80, 40)]
    pf = [float(x) for x in rng.uniform(0, 80, 40)]
    assert t_evaluator.mean_absolute_error(tf, pf) == \
        sklearn.metrics.mean_absolute_error(tf, pf)


def _face_labels(rng, n, regression):
    age = (lambda: float(rng.uniform(0, 90))) if regression else \
        (lambda: int(rng.integers(-1, 9)))
    return [{"gender": int(rng.integers(-1, 2)), "age": age(),
             "ethnicity": int(rng.integers(-1, 4)),
             "emotion": int(rng.integers(-1, 7))} for _ in range(n)]


@pytest.mark.parametrize("case", ["mivia", "face_auto", "face_regression"])
def test_evaluator_same_artifacts(case, tmp_path):
    rng = np.random.default_rng(1)
    if case == "mivia":
        keys = ("upper", "lower", "gender", "bag", "hat")
        preds = [{k: int(rng.integers(-1, 12)) for k in keys}
                 for _ in range(30)]
        gts = [{k: int(rng.integers(-1, 12)) for k in keys}
               for _ in range(30)]
        name, mode = "MiviaPar", "auto"
    else:
        regression = case == "face_regression"
        preds = _face_labels(rng, 30, regression)
        gts = _face_labels(rng, 30, regression)
        name, mode = "TestDataset", "regression" if regression else "auto"
    for evaluator, sub in ((TEvaluator, "port"), (JEvaluator, "ref")):
        evaluator.evaluate(preds, gts, tmp_path / sub, dataset_name=name,
                           age_mode=mode)
    for f in ("preds.json", "gts.json", "metrics.json"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "ref" / f).read_text()
    pngs = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert pngs == sorted(p.name for p in (tmp_path / "ref").glob("*.png"))
    assert pngs


@pytest.mark.parametrize("dataset", ["MiviaPar", "TestDataset"])
def test_run_zero_shot_same_preds(dataset, mivia_base, face_base, tmp_path):
    """Both drivers, with the port's model, over the same synthetic split:
    the same preds.json, gts.json and metrics.json."""
    base = mivia_base if dataset == "MiviaPar" else face_base
    model = create_model("paligemma", quantization="fp32", size="test",
                         device="cpu", batch_size=2)
    out = {}
    for run, factory, sub in ((t_run_zero_shot, TFactory, "port"),
                              (j_run_zero_shot, JFactory, "ref")):
        ds = factory.create_dataset(dataset, split="test", base_path=base)
        random.seed(0)    # the face parser's "asian" tie-break
        out[sub] = run(model, ds, "describe", tmp_path / sub, max_tokens=3,
                       batch_size=2)
        assert out[sub]["images_completed"] == len(ds)
    assert out["port"]["metrics"] == out["ref"]["metrics"]
    for f in ("preds.json", "gts.json", "metrics.json"):
        assert json.loads((tmp_path / "port" / f).read_text()) == \
            json.loads((tmp_path / "ref" / f).read_text())


def test_dataset_factory_registry_matches():
    assert TFactory.get_available_datasets() == \
        JFactory.get_available_datasets()
    with pytest.raises(ValueError, match="not registered"):
        TFactory.create_dataset("NoSuchDataset")
