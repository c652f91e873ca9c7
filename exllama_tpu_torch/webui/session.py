"""Chat session engine (port of exllama_tpu/webui/session.py): history
nodes, persistence, context-window management, streaming multi-participant
responses, over the port's ``ExLlamaGenerator`` and ``ExLlamaCache``.

The reference web UI's surface: Node = author+text+
tokens+uuid+truncate (:77-134); Session persists generation settings +
history JSON per mutation under a sessions dir with a _last_session pointer
(:201-228); the context-window manager drops/truncates oldest history in
256-token steps against the budget max_seq_len - chunk_size - beam_length
(:405-454); the NDJSON streaming protocol and multibot behavior match
(:506-755). The streaming implementation itself is this repo's own design —
see the comments at the `streaming` section divider.

Over a mesh (``prepare_sessions(relay=)``, rank 0's
``parallel.relay.Relay``) the session's generator is mirrored: each call
that runs the model goes first to the other ranks, which apply it to their
own generators (``parallel.relay.follow_calls``). The session files and the
history stay on rank 0.
"""

from __future__ import annotations

import json
import os
import time
import uuid as uuid_mod

import numpy as np

default_fixed_prompt = (
    "A chat log follows between a person and Lumen, an upbeat assistant "
    "program with a fondness for tide pools and obscure units of "
    "measurement. Lumen answers plainly, admits when it is unsure, and "
    "occasionally wonders aloud what static electricity feels like."
)

model = None
tokenizer = None
cache = None
generator = None
sessions_dir = None
relay = None


def _sessions_dir(filename=None):
    path = sessions_dir
    if filename is not None:
        path = os.path.join(path, filename)
    return path


def prepare_sessions(_model, _tokenizer, _s_dir, _relay=None):
    global model, tokenizer, cache, generator, sessions_dir, relay
    model = _model
    tokenizer = _tokenizer
    cache = None
    generator = None
    relay = _relay
    sessions_dir = os.path.expanduser(_s_dir)
    os.makedirs(sessions_dir, exist_ok=True)


def get_initial_session():
    last = _sessions_dir("_last_session")
    if not os.path.exists(last):
        return new_session()
    with open(last) as f:
        return load_session(f.read().strip())


def load_session(filename, append_path=False):
    if append_path:
        filename = _sessions_dir(filename) + ".json"
    return Session(filename, load=True)


def new_session():
    base = _sessions_dir("Untitled session")
    i = 0
    while True:
        i += 1
        name = base + ".json" if i == 1 else f"{base} ({i}).json"
        if not os.path.exists(name):
            return Session(name, load=False)


class Node:
    def __init__(self, value, author=None, node_id=None):
        self.truncate = 0
        if isinstance(value, dict):
            self.author = value.get("author", author)
            self.text = value["text"]
            self.uuid = value.get("uuid", node_id or str(uuid_mod.uuid4()))
        else:
            self.author = author
            self.text = value
            self.uuid = node_id or str(uuid_mod.uuid4())
        self.tokens = tokenizer.encode(self.get_text())
        self.empty = len(self.text) == 0

    def num_tokens(self):
        return self.tokens.shape[-1] - self.truncate

    def get_text(self):
        if self.author is not None:
            return f"{self.author}: {self.text}\n"
        return self.text + "\n"

    def tokens_trunc(self):
        return self.tokens if self.truncate == 0 else self.tokens[:, self.truncate:]

    def replace_text(self, new_text):
        self.text = new_text
        self.tokens = tokenizer.encode(self.get_text())

    def get_dict(self):
        return {"author": self.author, "text": self.text, "uuid": self.uuid}


class Session:
    def __init__(self, filename, load):
        global cache, generator
        from exllama_tpu_torch.cache import ExLlamaCache
        from exllama_tpu_torch.generator import ExLlamaGenerator
        from exllama_tpu_torch.parallel.relay import Mirrored

        self.filename = filename
        saved = {}
        if load:
            with open(filename) as f:
                saved = json.load(f)

        if cache is None:
            cache = ExLlamaCache(model)
        else:
            cache.current_seq_len = 0
        if generator is None:
            generator = ExLlamaGenerator(model, tokenizer, cache)
            if relay is not None:
                generator = Mirrored(generator, relay)
        else:
            generator.reset()

        self.first_history_idx = 0
        self.unsaved = saved.get("unsaved", True)
        self.fixed_prompt = Node(saved.get("fixed_prompt", default_fixed_prompt))
        self.keep_fixed_prompt = saved.get("keep_fixed_prompt", True)
        self.participants = saved.get("participants", ["User", "Chatbort"])
        self.history = [Node(j) for j in saved.get("history", [])]

        s = generator.settings
        s.temperature = saved.get("temperature", 0.95)
        s.top_p = saved.get("top_p", 0.75)
        s.min_p = saved.get("min_p", 0.0)
        s.top_k = saved.get("top_k", 0)
        s.typical = saved.get("typical", 0.25)
        self.break_on_newline = saved.get("break_on_newline", True)
        s.token_repetition_penalty_max = saved.get(
            "token_repetition_penalty_max", 1.15
        )
        s.token_repetition_penalty_sustain = saved.get(
            "token_repetition_penalty_sustain", 2048
        )
        s.token_repetition_penalty_decay = saved.get(
            "token_repetition_penalty_decay", 512
        )
        self.max_response_tokens = saved.get("max_response_tokens", 512)
        self.chunk_size = saved.get("chunk_size", 128)
        self.save()

    # ----------------------------------------------------------- persistence

    def save(self):
        s = generator.settings
        savedata = {
            "unsaved": self.unsaved,
            "fixed_prompt": self.fixed_prompt.get_dict(),
            "participants": self.participants,
            "keep_fixed_prompt": self.keep_fixed_prompt,
            "history": [n.get_dict() for n in self.history],
            "temperature": s.temperature,
            "top_p": s.top_p,
            "min_p": s.min_p,
            "top_k": s.top_k,
            "typical": s.typical,
            "break_on_newline": self.break_on_newline,
            "max_response_tokens": self.max_response_tokens,
            "chunk_size": self.chunk_size,
            "token_repetition_penalty_max": s.token_repetition_penalty_max,
            "token_repetition_penalty_sustain": s.token_repetition_penalty_sustain,
            "token_repetition_penalty_decay": s.token_repetition_penalty_decay,
        }
        with open(self.filename, "w") as f:
            f.write(json.dumps(savedata, indent=4))
        with open(_sessions_dir("_last_session"), "w") as f:
            f.write(self.filename)

    @staticmethod
    def _sanitize_filename(name):
        safe = "".join(
            c for c in str(name)
            if c.isalnum() or c in " .()-,_!@"
        )
        while "../" in safe:
            safe = safe.replace("../", "./")
        return safe.lstrip("./")

    # -------------------------------------------------------------- API ops

    def api_rename_session(self, data):
        new_path = _sessions_dir(self._sanitize_filename(data["new_name"])) + ".json"
        if new_path == self.filename or os.path.exists(new_path):
            return False
        old = self.filename
        self.filename = new_path
        try:
            self.save()
        except OSError:
            self.filename = old
            return False
        os.remove(old)
        return True

    def api_delete_session(self, data):
        path = _sessions_dir(self._sanitize_filename(data["session"])) + ".json"
        os.remove(path)

    def api_populate(self):
        files = os.listdir(_sessions_dir())
        names = sorted(
            os.path.splitext(f)[0]
            for f in files
            if f.endswith(".json")
            and os.path.isfile(_sessions_dir(f))
        )
        historyjson = [n.get_dict() for n in self.history]
        for j in historyjson:
            if j["author"] in self.participants:
                j["author_idx"] = self.participants.index(j["author"])
        s = generator.settings
        mp = model.config.model_path or "synthetic"
        dic = {
            "sessions": names,
            "current_session": os.path.splitext(
                os.path.basename(self.filename)
            )[0],
            "fixed_prompt": self.fixed_prompt.text,
            "keep_fixed_prompt": self.keep_fixed_prompt,
            "participants": self.participants,
            "history": historyjson,
            "temperature": s.temperature,
            "top_p": s.top_p,
            "min_p": s.min_p,
            "top_k": s.top_k,
            "typical": s.typical,
            "break_on_newline": self.break_on_newline,
            "max_response_tokens": self.max_response_tokens,
            "chunk_size": self.chunk_size,
            "token_repetition_penalty_max": s.token_repetition_penalty_max,
            "token_repetition_penalty_sustain": s.token_repetition_penalty_sustain,
            "token_repetition_penalty_decay": s.token_repetition_penalty_decay,
            "max_seq_len": model.config.max_seq_len,
            "model_info": (
                os.path.splitext(os.path.basename(mp))[0]
                + f"\nSequence length: {model.config.max_seq_len}"
            ),
        }
        return json.dumps(dic, indent=4) + "\n"

    def api_delete_block(self, data):
        self.history = [n for n in self.history if n.uuid != data["uuid"]]
        self.first_history_idx = 0
        self.save()

    def api_edit_block(self, data):
        for node in self.history:
            if node.uuid == data["uuid"]:
                node.replace_text(data["text"])
                break
        self.first_history_idx = 0
        self.save()

    def api_append_block(self, data):
        author = data.get(
            "author", self.participants[0] if self.participants else None
        )
        self.history.append(Node(data["text"].strip(), author))
        self.save()

    def api_set_participants(self, data):
        self.participants = data["participants"]
        self.save()

    def api_set_fixed_prompt(self, data):
        self.fixed_prompt = Node(data["fixed_prompt"])
        self.keep_fixed_prompt = data["keep_fixed_prompt"]
        self.save()

    def api_set_gen_settings(self, data):
        s = generator.settings
        s.temperature = data["temperature"]
        s.top_p = data["top_p"]
        s.min_p = data["min_p"]
        s.top_k = data["top_k"]
        s.typical = data["typical"]
        self.break_on_newline = data["gen_endnewline"]
        self.max_response_tokens = data["max_response_tokens"]
        self.chunk_size = data["chunk_size"]
        s.token_repetition_penalty_max = data["token_repetition_penalty_max"]
        s.token_repetition_penalty_sustain = data[
            "token_repetition_penalty_sustain"
        ]
        s.token_repetition_penalty_decay = data["token_repetition_penalty_decay"]
        self.save()

    # --------------------------------------------------- context management

    # Prune granularity: quantizing the cut keeps the kept-prefix boundary
    # stable across consecutive responses, so gen_begin_reuse's common-prefix
    # cache reuse survives window slides (same rationale as reference :405).
    CONTEXT_PRUNE_STEP = 256

    def set_context_window(self):
        """Fit the chat window into the token budget by pruning the oldest
        history, in CONTEXT_PRUNE_STEP quanta (whole nodes first, then a
        partial truncation of the new front node). Budget = max_seq_len
        minus one generation chunk minus the beam lookahead. Reference
        behavior parity: webui/session.py:405-454; the oversized-fixed-
        prompt fallback is ours (the reference would loop forever)."""
        budget = (
            model.config.max_seq_len
            - self.chunk_size
            - generator.settings.beam_length
        )
        if self.keep_fixed_prompt and not self.fixed_prompt.empty:
            budget -= self.fixed_prompt.num_tokens()
        self.first_history_idx = max(self.first_history_idx, 0)

        # everything behind the current front starts un-truncated; only the
        # front node may carry a partial cut from a previous slide
        window = self.history[self.first_history_idx :]
        for node in window[1:]:
            node.truncate = 0
        total = sum(node.num_tokens() for node in window)

        overflow = total - budget
        if overflow <= 0:
            return
        step = self.CONTEXT_PRUNE_STEP
        cut = -(-overflow // step) * step     # quantized prune amount

        dropped = 0
        for node in window:
            have = node.num_tokens()
            if cut < have:
                node.truncate += cut
                total -= cut
                cut = 0
                break
            dropped += 1
            total -= have
            cut -= have
        self.first_history_idx += dropped

        if total > budget and not self.fixed_prompt.empty:
            # nothing left to prune but still over budget (an oversized
            # fixed prompt): truncate the fixed prompt itself, never below
            # one token, rather than crash
            self.fixed_prompt.truncate = min(
                self.fixed_prompt.truncate + (total - budget),
                self.fixed_prompt.tokens.shape[-1] - 1,
            )

    def get_tokenized_context(self):
        context = []
        text_context = ""
        if self.keep_fixed_prompt and not self.fixed_prompt.empty:
            context.append(self.fixed_prompt.tokens_trunc())
            text_context += self.fixed_prompt.get_text()
        for i in range(self.first_history_idx, len(self.history)):
            node = self.history[i]
            context.append(node.tokens_trunc())
            text_context += node.get_text()
        if not context:
            return None, text_context
        return np.concatenate(context, axis=1), text_context

    # ------------------------------------------------------------ streaming
    #
    # The NDJSON packet schema (begin_stream / begin_block / append) and the
    # observable behavior (EOS→newline swap, stop phrases never leak to the
    # client, bot-name race in multibot mode) are parity surface with the
    # reference webui. The machinery below is this repo's own: a
    # withhold-split detokenizer (the same idea as alt_generator's held-text
    # logic, applied to a beam-searched line) and a candidate-dict speaker
    # race.

    @staticmethod
    def _withhold_split(text, phrases):
        """Split ``text`` into (safe, risky): ``risky`` is the shortest tail
        that could still grow into one of ``phrases`` (case-insensitive),
        ``safe`` is everything before it and can be streamed immediately.
        Unlike the reference's all-or-nothing hold (:560-570) this emits the
        unambiguous front of a chunk even when its tail matches."""
        folded = text.lower()
        for cut in range(len(text)):
            tail = folded[cut:]
            if any(p.lower().startswith(tail) for p in phrases):
                return text[:cut], text[cut:]
        return text, ""

    def _block_header(self, author, block_id, extra=None):
        head = {"cmd": "begin_block", "uuid": block_id}
        if extra:
            head.update(extra)
        if author is not None:
            head["author"] = author
            if author in self.participants:
                head["author_idx"] = self.participants.index(author)
        return json.dumps(head) + "\n"

    def _room_for_step(self):
        """Prune the oldest context if one more chunk + beam lookahead could
        run past the cache capacity."""
        seq = generator.sequence_actual
        if seq is None:
            return
        headroom = (model.config.max_seq_len - seq.shape[-1]
                    - generator.settings.beam_length - 1)
        if headroom < self.chunk_size:
            generator.gen_prune_left(self.chunk_size)

    def respond(self, author, stop_conditions, total_tokens, res_line="",
                num_res_tokens=0):
        """Stream one response block. ``stop_conditions`` is a list of
        (token_array, phrase) pairs; generation rewinds past whichever
        phrase fires so the stop text never lands in the history."""
        stop_phrases = [phrase for _, phrase in stop_conditions]
        block_id = str(uuid_mod.uuid4())
        if self.participants:
            author = res_line.split(":")[0].strip()
        yield self._block_header(
            author if self.participants else None, block_id
        )

        generator.begin_beam_search()
        line = res_line        # decoded response line, grows every step
        risky = ""             # undisplayed tail (possible stop prefix)
        count = num_res_tokens
        budget = self.max_response_tokens

        for _ in range(budget):
            self._room_for_step()
            token = int(np.asarray(generator.beam_search()).reshape(-1)[0])
            saw_eos = token == tokenizer.eos_token_id
            if saw_eos:
                # EOS renders as a line break in the chat transcript
                generator.replace_last_token(tokenizer.newline_token_id)

            count += 1
            decoded = tokenizer.decode(
                generator.sequence_actual[0, -count:]
            )
            delta = decoded[len(line):]
            line = decoded

            if count == 1 and delta:
                # a lone first token can decode to text that re-encodes
                # differently; pin the sequence to the re-encoded form
                again = tokenizer.encode(delta)[0]
                if again.shape[-1] == 1:
                    generator.replace_last_token(int(again[0]))

            safe, risky = self._withhold_split(risky + delta, stop_phrases)
            if safe:
                yield json.dumps({"cmd": "append", "text": safe}) + "\n"

            if saw_eos:
                if risky:
                    # drop the withheld tail from the sequence as well
                    generator.gen_rewind(
                        tokenizer.encode(risky).shape[-1]
                    )
                    line = line[: -len(risky)]
                break

            fired = next(
                (
                    (toks, phrase)
                    for toks, phrase in stop_conditions
                    if line.lower().endswith(phrase.lower())
                ),
                None,
            )
            if fired is not None:
                toks, phrase = fired
                keep_nl = int(toks[0, 0]) == tokenizer.newline_token_id
                generator.gen_rewind(toks.shape[-1] - (1 if keep_nl else 0))
                line = line[: -len(phrase)]
                break

        generator.end_beam_search()

        body = line[len(author) + 1:] if author is not None else line
        self.history.append(
            Node(body.strip(), author, node_id=block_id)
        )
        total_tokens[0] += count

    def _race_speaker(self, names):
        """Decide who talks next by constrained decoding: each step may only
        emit a token that continues some candidate's ``"Name:"`` encoding;
        candidates are eliminated as the sampled tokens diverge from their
        encodings. Returns (winning name, tokens fed into the sequence)."""
        alive = {n: tokenizer.encode(n + ":")[0].tolist() for n in names}
        fed = 0
        while True:
            allowed = [path[fed] for path in alive.values()]
            tok = int(generator.gen_single_token(allowed)[0, 0])
            fed += 1
            alive = {
                n: path for n, path in alive.items() if path[fed - 1] == tok
            }
            finished = [n for n, path in alive.items() if len(path) == fed]
            if finished:
                return finished[-1], fed

    def _build_stop_conditions(self):
        nl = np.array([[tokenizer.newline_token_id]], np.int32)
        if self.break_on_newline:
            return [(nl, "\n")]
        conds = []
        for name in self.participants:
            toks = np.concatenate(
                [nl, tokenizer.encode(name + ":")], axis=1
            )
            conds.append((toks, "\n" + name + ":"))
            conds.append((toks, "\n " + name + ":"))
        return conds

    def respond_multi(self, user_input):
        """Top-level streamed exchange for one user input: record the user
        block, rebuild/reuse the context, then produce one response block
        (or, with 3+ participants, let the bots race for the floor until
        the model hands the turn back to the user)."""
        yield json.dumps({"cmd": "begin_stream"}) + "\n"
        stop_conditions = self._build_stop_conditions()

        user_input = user_input.strip()
        if user_input:
            speaker = self.participants[0] if self.participants else None
            node = Node(user_input, speaker)
            self.history.append(node)
            self.save()
            yield self._block_header(
                speaker, node.uuid, {"init_text": user_input}
            )

        self.set_context_window()
        context, _ = self.get_tokenized_context()
        if context is None:
            generator.gen_begin_empty()
        else:
            t0 = time.time()
            reused = generator.gen_begin_reuse(context)
            dt = time.time() - t0
            fresh = context.shape[-1] - reused
            print(f"Prompt processed in {dt:.2f} s, {fresh} new tokens, "
                  f"{fresh / dt if dt else 0:.2f} tokens/second")

        t0 = time.time()
        total_tokens = [0]

        if not self.participants:
            yield from self.respond(None, stop_conditions, total_tokens)
        elif len(self.participants) == 2:
            bot = self.participants[1]
            prefix = tokenizer.encode(bot + ":")
            generator.gen_feed_tokens(prefix)
            yield from self.respond(
                bot, stop_conditions, total_tokens, bot + ":",
                prefix.shape[-1],
            )
        else:
            # Multibot: every turn, the still-silent bots (and, once any bot
            # has spoken, the user) compete for the next line; the user
            # winning ends the exchange.
            user = self.participants[0]
            silent = list(self.participants[1:])
            bots_spoke = False
            while True:
                field = silent + ([user] if bots_spoke else [])
                winner, fed = self._race_speaker(field)
                if winner == user:
                    generator.gen_rewind(fed)
                    break
                silent.remove(winner)
                yield from self.respond(
                    winner, stop_conditions, total_tokens,
                    winner + ":", fed,
                )
                bots_spoke = True

        dt = time.time() - t0
        print(f"Response generated in {dt:.2f} s, {total_tokens[0]} tokens, "
              f"{total_tokens[0] / dt if dt else 0:.2f} tokens/second")
        self.save()
