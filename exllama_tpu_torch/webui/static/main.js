/* exllama_tpu_torch web UI client.
 *
 * Drives every server route (webui/app.py): populate, session
 * new/switch/rename/delete, node edit/delete/append, participants, fixed
 * prompt, generation settings, and the streaming NDJSON /api/userinput
 * response. Feature-parity rebuild of the reference client
 * (its webui/static/main.js), written fresh against our
 * route/packet schema. */

"use strict";

// ------------------------------------------------------------------- state

let state = {
  sessions: [],
  currentSession: null,
  participants: [],
  history: [],          // [{uuid, author, author_idx, text}]
  generating: false,
};

const SETTING_DEFS = [
  // key, label, min, max, step
  ["temperature", "temperature", 0.05, 3.0, 0.05],
  ["top_k", "top_k", 0, 200, 1],
  ["top_p", "top_p", 0.0, 1.0, 0.01],
  ["min_p", "min_p", 0.0, 0.5, 0.01],
  ["typical", "typical", 0.0, 1.0, 0.01],
  ["token_repetition_penalty_max", "repetition penalty", 1.0, 2.0, 0.01],
  ["token_repetition_penalty_sustain", "rep. sustain", 0, 2048, 16],
  ["token_repetition_penalty_decay", "rep. decay", 0, 2048, 16],
  ["max_response_tokens", "max response tokens", 16, 4096, 16],
  ["chunk_size", "chunk size", 16, 1024, 16],
];
let settingValues = {};

const $ = (id) => document.getElementById(id);

async function api(route, body) {
  const r = await fetch(route, {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(body || {}),
  });
  return r.json();
}

// ---------------------------------------------------------------- populate

async function populate() {
  const r = await fetch("/api/populate");
  const d = await r.json();
  state.sessions = d.sessions;
  state.currentSession = d.current_session;
  state.participants = d.participants || [];
  state.history = d.history || [];

  settingValues = {};
  for (const [key] of SETTING_DEFS) settingValues[key] = d[key];
  $("gen-endnewline").checked = !!d.break_on_newline;
  $("fixed-prompt").value = d.fixed_prompt || "";
  $("keep-fixed-prompt").checked = !!d.keep_fixed_prompt;
  $("model-info").textContent = d.model_info || "";

  renderSessions();
  renderParticipants();
  renderSettings();
  renderHistory();
}

// ---------------------------------------------------------------- sessions

function renderSessions() {
  const box = $("sessions");
  box.innerHTML = "";
  for (const name of state.sessions) {
    const row = document.createElement("div");
    row.className =
      "session-item" + (name === state.currentSession ? " active" : "");
    const label = document.createElement("span");
    label.className = "name";
    label.textContent = name;
    row.appendChild(label);

    const tools = document.createElement("span");
    tools.className = "tools";
    tools.appendChild(toolButton("✎", "Rename", (ev) => {
      ev.stopPropagation();
      startSessionRename(row, name);
    }));
    tools.appendChild(toolButton("✕", "Delete", async (ev) => {
      ev.stopPropagation();
      if (!confirm(`Delete session "${name}"?`)) return;
      await api("/api/delete_session", { session: name });
      if (name === state.currentSession)
        await api("/api/set_session", { session_name: "." });
      await populate();
    }));
    row.appendChild(tools);

    row.onclick = async () => {
      if (state.generating || name === state.currentSession) return;
      await api("/api/set_session", { session_name: name });
      await populate();
    };
    box.appendChild(row);
  }
}

function startSessionRename(row, oldName) {
  const input = document.createElement("input");
  input.value = oldName;
  row.innerHTML = "";
  row.appendChild(input);
  input.focus();
  input.select();
  const done = async (commit) => {
    const newName = input.value.trim();
    if (commit && newName && newName !== oldName) {
      if (oldName !== state.currentSession)
        await api("/api/set_session", { session_name: oldName });
      const res = await api("/api/rename_session", { new_name: newName });
      if (res.result !== "ok") alert("Rename failed (name taken?)");
    }
    await populate();
  };
  input.onkeydown = (e) => {
    if (e.key === "Enter") done(true);
    if (e.key === "Escape") done(false);
  };
  input.onblur = () => done(false);
}

$("btn-new-session").onclick = async () => {
  if (state.generating) return;
  await api("/api/set_session", { session_name: "." });
  await populate();
};

// ------------------------------------------------------------ participants

function authorColor(idx) {
  if (idx == null || idx < 0) return "var(--author-1)";
  return `var(--author-${idx % 5})`;
}

function renderParticipants() {
  const box = $("participants");
  box.innerHTML = "";
  state.participants.forEach((p, i) => {
    const row = document.createElement("div");
    row.className = "part-item";
    const dot = document.createElement("span");
    dot.className = "dot";
    dot.style.background = authorColor(i);
    row.appendChild(dot);
    const name = document.createElement("span");
    name.className = "name";
    name.textContent = p + (i === 0 ? "  (you)" : "");
    name.ondblclick = () => startParticipantEdit(row, i);
    row.appendChild(name);
    row.appendChild(toolButton("✕", "Remove", async () => {
      const parts = state.participants.slice();
      parts.splice(i, 1);
      await api("/api/set_participants", { participants: parts });
      await populate();
    }));
    box.appendChild(row);
  });
}

function startParticipantEdit(row, idx) {
  const input = document.createElement("input");
  input.value = state.participants[idx];
  row.innerHTML = "";
  row.appendChild(input);
  input.focus();
  input.select();
  const done = async (commit) => {
    const v = input.value.trim();
    if (commit && v) {
      const parts = state.participants.slice();
      parts[idx] = v;
      await api("/api/set_participants", { participants: parts });
    }
    await populate();
  };
  input.onkeydown = (e) => {
    if (e.key === "Enter") done(true);
    if (e.key === "Escape") done(false);
  };
  input.onblur = () => done(false);
}

$("btn-add-part").onclick = async () => {
  const name = prompt("Participant name:");
  if (!name) return;
  const parts = state.participants.concat([name.trim()]);
  await api("/api/set_participants", { participants: parts });
  await populate();
};

// ---------------------------------------------------------------- settings

function renderSettings() {
  const box = $("settings");
  box.innerHTML = "";
  for (const [key, label, min, max, step] of SETTING_DEFS) {
    const wrap = document.createElement("div");
    wrap.className = "setting";
    const lab = document.createElement("div");
    lab.className = "lab";
    const val = document.createElement("span");
    val.className = "val";
    val.textContent = fmtNum(settingValues[key]);
    lab.innerHTML = `<span>${label}</span>`;
    lab.appendChild(val);
    const slider = document.createElement("input");
    slider.type = "range";
    slider.min = min;
    slider.max = max;
    slider.step = step;
    slider.value = settingValues[key];
    slider.oninput = () => {
      settingValues[key] = parseFloat(slider.value);
      val.textContent = fmtNum(settingValues[key]);
    };
    wrap.appendChild(lab);
    wrap.appendChild(slider);
    box.appendChild(wrap);
  }
}

function fmtNum(v) {
  if (v == null) return "–";
  return Number.isInteger(v) ? String(v) : v.toFixed(2);
}

$("btn-save-settings").onclick = async () => {
  const body = {};
  for (const [key] of SETTING_DEFS) body[key] = settingValues[key];
  body.gen_endnewline = $("gen-endnewline").checked;
  await api("/api/set_gen_settings", body);
};

$("btn-save-fixed").onclick = async () => {
  await api("/api/set_fixed_prompt", {
    fixed_prompt: $("fixed-prompt").value,
    keep_fixed_prompt: $("keep-fixed-prompt").checked,
  });
};

// ----------------------------------------------------------------- blocks

function toolButton(txt, title, onclick) {
  const b = document.createElement("button");
  b.className = "tool";
  b.textContent = txt;
  b.title = title;
  b.onclick = onclick;
  return b;
}

function makeBlock(node) {
  const div = document.createElement("div");
  div.className = "block";
  div.dataset.uuid = node.uuid || "";

  if (node.author) {
    const author = document.createElement("div");
    author.className = "author";
    author.textContent = node.author;
    author.style.color = authorColor(node.author_idx);
    div.appendChild(author);
  }
  const text = document.createElement("div");
  text.className = "text";
  text.textContent = node.text || "";
  div.appendChild(text);

  const tools = document.createElement("div");
  tools.className = "tools";
  tools.appendChild(toolButton("✎", "Edit block", () => startBlockEdit(div)));
  tools.appendChild(toolButton("✕", "Delete block", async () => {
    await api("/api/delete_block", { uuid: div.dataset.uuid });
    await populate();
  }));
  div.appendChild(tools);
  return div;
}

function startBlockEdit(div) {
  if (div.querySelector("textarea.edit")) return;
  const text = div.querySelector(".text");
  const ta = document.createElement("textarea");
  ta.className = "edit";
  ta.value = text.textContent;
  text.style.display = "none";
  const actions = document.createElement("div");
  actions.className = "edit-actions";
  const save = document.createElement("button");
  save.textContent = "Save";
  save.onclick = async () => {
    await api("/api/edit_block", { uuid: div.dataset.uuid, text: ta.value });
    await populate();
  };
  const cancel = document.createElement("button");
  cancel.className = "secondary";
  cancel.textContent = "Cancel";
  cancel.onclick = () => {
    ta.remove();
    actions.remove();
    text.style.display = "";
  };
  actions.appendChild(save);
  actions.appendChild(cancel);
  div.appendChild(ta);
  div.appendChild(actions);
  ta.focus();
}

function renderHistory() {
  const chat = $("chat");
  chat.innerHTML = "";
  for (const node of state.history) chat.appendChild(makeBlock(node));
  chat.scrollTop = chat.scrollHeight;
}

// -------------------------------------------------------------- streaming

let streamBlock = null;   // current .text element being appended to
let streamCursor = null;

function beginStreamBlock(packet) {
  const chat = $("chat");
  const div = makeBlock({
    uuid: packet.uuid,
    author: packet.author,
    author_idx: packet.author_idx,
    text: packet.init_text || "",
  });
  chat.appendChild(div);
  streamBlock = div.querySelector(".text");
  if (!packet.init_text) {
    streamCursor = document.createElement("span");
    streamCursor.className = "cursor";
    streamBlock.appendChild(streamCursor);
  } else {
    streamCursor = null;
  }
  chat.scrollTop = chat.scrollHeight;
}

function appendStreamText(text) {
  if (!streamBlock) return;
  if (streamCursor) streamCursor.remove();
  streamBlock.textContent += text;
  if (streamCursor) streamBlock.appendChild(streamCursor);
  const chat = $("chat");
  chat.scrollTop = chat.scrollHeight;
}

function handlePacket(packet) {
  switch (packet.cmd) {
    case "begin_stream":
      break;
    case "begin_block":
      beginStreamBlock(packet);
      break;
    case "append":
      appendStreamText(packet.text);
      break;
    default:
      console.warn("unknown packet", packet);
  }
}

async function sendUserInput(text) {
  if (state.generating) return;
  state.generating = true;
  setButtonsEnabled(false);
  try {
    const resp = await fetch("/api/userinput", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ user_input: text }),
    });
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      let nl;
      while ((nl = buf.indexOf("\n")) >= 0) {
        const line = buf.slice(0, nl).trim();
        buf = buf.slice(nl + 1);
        if (!line) continue;
        try {
          handlePacket(JSON.parse(line));
        } catch (e) {
          console.warn("bad packet line", line);
        }
      }
    }
  } finally {
    if (streamCursor) streamCursor.remove();
    streamBlock = null;
    streamCursor = null;
    state.generating = false;
    setButtonsEnabled(true);
    await populate();   // sync uuids/author idx of the new blocks
  }
}

function setButtonsEnabled(on) {
  for (const id of ["btn-send", "btn-append", "btn-continue",
                    "btn-new-session"])
    $(id).disabled = !on;
}

// ------------------------------------------------------------------ input

$("btn-send").onclick = () => {
  const text = $("userinput").value;
  if (state.generating) return;
  $("userinput").value = "";
  sendUserInput(text);
};

$("btn-continue").onclick = () => {
  if (state.generating) return;
  sendUserInput("");
};

$("btn-append").onclick = async () => {
  const text = $("userinput").value.trim();
  if (!text || state.generating) return;
  $("userinput").value = "";
  await api("/api/append_block", { text: text });
  await populate();
};

$("userinput").addEventListener("keydown", (e) => {
  if (e.key === "Enter" && !e.shiftKey) {
    e.preventDefault();
    $("btn-send").onclick();
  }
});

// ------------------------------------------------------------------- boot

populate();
