"""Streaming generation with stop conditions (ExLlamaAltGenerator)."""

from exllama_tpu_torch.alt_generator import ExLlamaAltGenerator
from exllama_tpu_torch.examples.common import build_from_args


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args("streaming",
                                                         argv=argv)
    generator = ExLlamaAltGenerator(model, tokenizer, cache)
    settings = ExLlamaAltGenerator.Settings()
    settings.temperature = 0.8
    prompt = "A short poem about the GPU:\n\n"
    stop_conditions = ["\n\n", tokenizer.eos_token_id]
    generator.begin_stream(prompt, stop_conditions, args.max_new or 200,
                           settings)
    print(prompt, end="", flush=True)
    while True:
        chunk, eos = generator.stream()
        print(chunk, end="", flush=True)
        if eos:
            break
    print()


if __name__ == "__main__":
    main()
