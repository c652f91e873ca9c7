"""Classifier-free guidance over a (positive, negative) system-prompt pair;
alpha sweeps from interpolation to extrapolation between the two."""

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.generator import ExLlamaGenerator

F_POSITIVE = "[INST] You are a helpful assistant. {prompt} [/INST]"
F_NEGATIVE = "[INST] You are a rude and obnoxious assistant. {prompt} [/INST]"


def main(argv=None):
    question = "Tell me about Homer Simpson"
    prompts = [F_POSITIVE.replace("{prompt}", question),
               F_NEGATIVE.replace("{prompt}", question)]
    args, cfg, model, tokenizer, cache = build_from_args("CFG", batch_size=2,
                                                         argv=argv)
    generator = ExLlamaGenerator(model, tokenizer, cache)
    for i in range(10):
        alpha = i / 5.0 - 0.4
        print(f"\n----- alpha = {alpha:.1f} -----")
        output = generator.generate_cfg(prompts, alpha,
                                        max_new_tokens=args.max_new or 200)
        print(output[len(prompts[0]):].strip())


if __name__ == "__main__":
    main()
