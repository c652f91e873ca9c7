"""Interactive terminal chatbot: a fixed persona prompt, streaming
token-by-token output, break-on-newline, and a rewind when the model tries
to speak for the user. Reads lines from stdin until EOF, "quit" or
"exit" (over a mesh: rank 0 reads them and relays each line)."""

from exllama_tpu_torch.examples.common import build_from_args, read_line
from exllama_tpu_torch.generator import ExLlamaGenerator
from exllama_tpu_torch.parallel.relay import relay_for


def extra(parser):
    parser.add_argument("-un", "--username", default="User")
    parser.add_argument("-bn", "--botname", default="Chatbort")
    parser.add_argument("-p", "--prompt_file", default=None,
                        help="file with the initial persona prompt")
    parser.add_argument("-nnl", "--no_newline", action="store_true",
                        help="don't break responses on newline")


def main(argv=None):
    args, cfg, model, tokenizer, cache = build_from_args(
        "chatbot", extra_args=extra, argv=argv)
    generator = ExLlamaGenerator(model, tokenizer, cache)
    generator.settings.temperature = 0.95
    generator.settings.top_k = 20
    generator.settings.top_p = 0.65
    generator.settings.token_repetition_penalty_max = 1.15
    generator.settings.token_repetition_penalty_sustain = cfg.max_seq_len // 2

    user, bot = args.username, args.botname
    if args.prompt_file:
        with open(args.prompt_file) as f:
            past = f.read().replace("{username}", user).replace(
                "{bot_name}", bot)
    else:
        past = (f"This is a conversation between {user} and a curious "
                f"chatbot named {bot}.\n")
    generator.gen_begin(tokenizer.encode(past))
    print(past, end="", flush=True)
    break_on_newline = not args.no_newline
    max_response_tokens = args.max_new or 256

    relay = relay_for(model)        # rank 0 reads stdin for every rank
    while True:
        line = read_line(f"{user}: ", relay)
        if line is None or line in ("quit", "exit"):
            break
        # keep room in the cache for the turn and the response
        turn = tokenizer.encode(f"{user}: {line}\n{bot}:")
        room = cfg.max_seq_len - max_response_tokens - turn.shape[-1] - 1
        if generator.sequence_actual.shape[-1] > room:
            generator.gen_prune_left(generator.sequence_actual.shape[-1]
                                     - max(room, 1))
        generator.gen_feed_tokens(turn)
        print(f"{bot}:", end="", flush=True)

        res_line = f"{bot}:"
        num_res_tokens = 0
        for _ in range(max_response_tokens):
            token = generator.gen_single_token()
            tid = int(token[0, 0])
            num_res_tokens += 1
            prev = res_line
            res_line = f"{bot}:" + tokenizer.decode(
                generator.sequence_actual[0, -num_res_tokens:])
            print(res_line[len(prev):], end="", flush=True)
            if tid == tokenizer.eos_token_id:
                break
            if break_on_newline and tid == tokenizer.newline_token_id:
                break
            # the model tries to take over the user's turn: rewind it
            if res_line.endswith(f"{user}:"):
                generator.gen_rewind(tokenizer.encode(f"{user}:").shape[-1])
                print("\r" + " " * len(res_line) + "\r", end="")
                break
        print()


if __name__ == "__main__":
    main()
