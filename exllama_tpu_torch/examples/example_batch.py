"""Batched generation with left-padded prompts."""

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.generator import ExLlamaGenerator

PROMPTS = [
    "Once upon a time,",
    "I don't like to",
    "A turbo encabulator is a",
    "In the words of Mark Twain,",
]


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args(
        "batched generation", batch_size=len(PROMPTS), argv=argv)
    generator = ExLlamaGenerator(model, tokenizer, cache)
    generator.settings.top_k = 40
    for line in generator.generate_simple(
            PROMPTS, max_new_tokens=args.max_new or 100):
        print(line)
        print("---")


if __name__ == "__main__":
    main()
