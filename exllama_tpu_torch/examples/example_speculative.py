"""Speculative decoding with n-gram prompt-lookup drafting: one forward
verifies up to max_draft drafted tokens; at top-k 1 the output is the
plain greedy decode's. (A draft model drafts through
``speculative.DraftModelProposer(draft_model)`` instead.)"""

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.speculative import NgramProposer, SpeculativeGenerator


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args(
        "Speculative decoding example", argv=argv)
    gen = SpeculativeGenerator(model, tokenizer, cache,
                               NgramProposer(max_ngram=3, max_draft=8))
    gen.settings.top_k = 1
    print(gen.generate_simple("def fibonacci(n):\n    ",
                              max_new_tokens=args.max_new or 128))
    print(f"-- {gen.stats['tokens']} tokens in {gen.stats['forwards']} "
          f"forwards, acceptance {gen.acceptance_rate:.0%}")


if __name__ == "__main__":
    main()
