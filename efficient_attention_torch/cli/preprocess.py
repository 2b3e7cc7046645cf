"""Corpus binarization CLI of the port (``fairseq_cli/preprocess.py``).

Counterpart of ``efficient_attention_tpu/cli/preprocess.py``, with its
flags: builds a :class:`Dictionary` from the training text and writes
``.bin``/``.idx`` files for each split, monolingual (LM: no languages, or
``--only-source``) or paired (MT: ``-s``/``-t``, one dictionary a side or
``--joined-dictionary``).  ``--srcdict``/``--tgtdict`` reuse existing
dictionaries, ``--threshold*``/``--nwords*`` prune a side, ``--dict-only``
stops after writing the dictionaries.  Its output is byte for byte the JAX
CLI's.

Example (a WikiText-103-style LM corpus):

  python -m efficient_attention_torch.cli.preprocess --only-source \\
      --trainpref wiki.train.tokens --validpref wiki.valid.tokens \\
      --testpref wiki.test.tokens --destdir data-bin/wikitext-103
"""
from __future__ import annotations

import argparse
import os

from efficient_attention_torch.data.dictionary import Dictionary
from efficient_attention_torch.data.indexed_dataset import binarize_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("eatorch-preprocess")
    p.add_argument("--trainpref", required=True)
    p.add_argument("--validpref", default=None)
    p.add_argument("--testpref", default=None)
    p.add_argument("--destdir", required=True)
    p.add_argument("--source-lang", "-s", default=None)
    p.add_argument("--target-lang", "-t", default=None)
    p.add_argument("--thresholdsrc", type=int, default=-1,
                   help="map source words seen fewer times to <unk>")
    p.add_argument("--thresholdtgt", type=int, default=-1)
    p.add_argument("--nwordssrc", type=int, default=-1,
                   help="keep only the top N source symbols")
    p.add_argument("--nwordstgt", type=int, default=-1)
    p.add_argument("--srcdict", default=None,
                   help="reuse this dictionary file instead of building one")
    p.add_argument("--tgtdict", default=None)
    p.add_argument("--joined-dictionary", action="store_true")
    p.add_argument("--only-source", action="store_true")
    p.add_argument("--dict-only", action="store_true",
                   help="write the dictionaries and stop")
    return p


def _binarize(text_path, dictionary, out_prefix):
    stats = binarize_file(text_path, dictionary, out_prefix)
    print(f"| {text_path}: {stats['sequences']} sents, {stats['tokens']} "
          f"tokens, {100 * stats['unk'] / max(stats['tokens'], 1):.2f}% <unk>")


def main(args) -> None:
    os.makedirs(args.destdir, exist_ok=True)
    langs = [lang for lang in (args.source_lang, args.target_lang) if lang] or [None]
    if args.only_source and args.target_lang:
        langs = [args.source_lang]

    def path(pref, lang):
        return f"{pref}.{lang}" if lang else pref

    def corpus_lines():
        for lang in langs:
            with open(path(args.trainpref, lang), encoding="utf-8") as f:
                yield from f

    def per_lang(lang):
        """(existing dictionary, threshold, nwords) of a side; the sides are
        independent, as in fairseq."""
        if lang is not None and lang == args.target_lang:
            return args.tgtdict, args.thresholdtgt, args.nwordstgt
        return args.srcdict, args.thresholdsrc, args.nwordssrc

    if args.joined_dictionary or len(langs) == 1:
        d = (Dictionary.load(args.srcdict) if args.srcdict else
             Dictionary.build_from_corpus(corpus_lines(), threshold=args.thresholdsrc,
                                          nwords=args.nwordssrc))
        dicts = {lang: d for lang in langs}
    else:
        dicts = {}
        for lang in langs:
            existing, threshold, nwords = per_lang(lang)
            if existing:
                dicts[lang] = Dictionary.load(existing)
            else:
                with open(path(args.trainpref, lang), encoding="utf-8") as f:
                    dicts[lang] = Dictionary.build_from_corpus(
                        f, threshold=threshold, nwords=nwords)

    for lang in langs:
        suffix = f".{lang}" if lang else ""
        dicts[lang].save(os.path.join(args.destdir, f"dict{suffix}.txt"))
    if args.dict_only:
        print(f"| Wrote dictionaries to {args.destdir} (--dict-only)")
        return
    for lang in langs:
        suffix = f".{lang}" if lang else ""
        for split, pref in (("train", args.trainpref), ("valid", args.validpref),
                            ("test", args.testpref)):
            if pref:
                _binarize(path(pref, lang), dicts[lang],
                          os.path.join(args.destdir, f"{split}{suffix}"))
    print(f"| Wrote preprocessed data to {args.destdir}")


def cli_main(argv=None) -> None:
    main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli_main()
