"""Minimal usage: model, cache, tokenizer, generator, generate_simple."""

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.generator import ExLlamaGenerator


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args("basic generation",
                                                         argv=argv)
    generator = ExLlamaGenerator(model, tokenizer, cache)
    generator.settings.token_repetition_penalty_max = 1.2
    generator.settings.temperature = 0.95
    generator.settings.top_p = 0.65
    generator.settings.top_k = 100
    print(generator.generate_simple("Once upon a time,",
                                    max_new_tokens=args.max_new or 200))


if __name__ == "__main__":
    main()
