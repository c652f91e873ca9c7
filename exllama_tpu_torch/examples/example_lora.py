"""Generation with a LoRA adapter on the quantized base weights
(``--lora_dir``: adapter_config.json + adapter_model.safetensors, e.g. one
written by ``utils.fabricate.fabricate_lora``)."""

import os

from exllama_tpu_torch.examples.common import build_from_args
from exllama_tpu_torch.generator import ExLlamaGenerator
from exllama_tpu_torch.lora import ExLlamaLora


def extra(parser):
    parser.add_argument("--lora_dir", required=True,
                        help="dir with adapter_config.json + "
                             "adapter_model.safetensors")


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args(
        "LoRA", extra_args=extra, argv=argv)
    lora = ExLlamaLora(
        model,
        os.path.join(args.lora_dir, "adapter_config.json"),
        os.path.join(args.lora_dir, "adapter_model.safetensors"),
    )
    generator = ExLlamaGenerator(model, tokenizer, cache)
    generator.lora = lora
    print(generator.generate_simple(
        "### Instruction:\nList five ways to improve attention.\n"
        "### Response:", max_new_tokens=args.max_new or 200))


if __name__ == "__main__":
    main()
