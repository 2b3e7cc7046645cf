#!/bin/bash
# Compound-split tokenized BLEU over a fairseq-style gen.out, with the
# PyTorch port's scorer.
#
# The same steps as scripts/compound_split_bleu.sh (fairseq's
# scripts/compound_split_bleu.sh, run by main.sh after generate): take the
# H- and T- lines, split hyphenated compounds into "a ##AT##-##AT## b", and
# score word-level BLEU with efficient_attention_torch.cli.score.
#
# Usage: bash scripts/torch_compound_split_bleu.sh GENERATE_OUTPUT
# (from the root of a checkout, or with the package on PYTHONPATH)

if [ $# -ne 1 ]; then
    echo "usage: $0 GENERATE_OUTPUT"
    exit 1
fi

GEN=$1

SYS=$GEN.sys
REF=$GEN.ref

if [ "$(tail -n 1 "$GEN" | grep BLEU | wc -l)" -ne 1 ]; then
    echo "not done generating"
    exit
fi

grep ^H "$GEN" | awk -F '\t' '{print $NF}' | perl -ple 's{(\S)-(\S)}{$1 ##AT##-##AT## $2}g' > "$SYS"
grep ^T "$GEN" | cut -f2- | perl -ple 's{(\S)-(\S)}{$1 ##AT##-##AT## $2}g' > "$REF"
python3 -m efficient_attention_torch.cli.score --sys "$SYS" --ref "$REF"
