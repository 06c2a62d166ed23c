// Chat client (capability parity with reference static/app.js:1-117):
// session management, history load, EventSource SSE streaming of tokens,
// clickable suggestions.
let sessionId = localStorage.getItem("rag_session") || null;

const messagesEl = document.getElementById("messages");
const suggestionsEl = document.getElementById("suggestions");
const sessionsEl = document.getElementById("sessions");
const inputEl = document.getElementById("input");

function addMsg(role, text) {
  const div = document.createElement("div");
  div.className = `msg ${role}`;
  div.textContent = text;
  messagesEl.appendChild(div);
  messagesEl.scrollTop = messagesEl.scrollHeight;
  return div;
}

function setSuggestions(items) {
  suggestionsEl.innerHTML = "";
  (items || []).forEach((s) => {
    const b = document.createElement("button");
    b.textContent = s;
    b.onclick = () => { inputEl.value = s; send(); };
    suggestionsEl.appendChild(b);
  });
}

async function loadSessions() {
  const res = await fetch("/chat/sessions");
  const data = await res.json();
  sessionsEl.innerHTML = "";
  data.sessions.forEach((s) => {
    const div = document.createElement("div");
    div.textContent = s.title || s.id.slice(0, 8);
    if (s.id === sessionId) div.className = "active";
    div.onclick = () => loadHistory(s.id);
    sessionsEl.appendChild(div);
  });
}

async function loadHistory(id) {
  sessionId = id;
  localStorage.setItem("rag_session", id);
  const res = await fetch(`/chat/history/${id}`);
  const data = await res.json();
  messagesEl.innerHTML = "";
  data.messages.forEach((m) => addMsg(m.role, m.content));
  loadSessions();
}

function send() {
  const text = inputEl.value.trim();
  if (!text) return;
  inputEl.value = "";
  addMsg("user", text);
  const bubble = addMsg("assistant", "");
  const params = new URLSearchParams({ message: text });
  if (sessionId) params.set("session_id", sessionId);
  const es = new EventSource(`/chat/stream?${params}`);
  es.addEventListener("token", (e) => {
    bubble.textContent += JSON.parse(e.data).token;
    messagesEl.scrollTop = messagesEl.scrollHeight;
  });
  es.addEventListener("done", (e) => {
    const data = JSON.parse(e.data);
    sessionId = data.session_id;
    localStorage.setItem("rag_session", sessionId);
    if (data.citations && data.citations.length) {
      const cite = document.createElement("div");
      cite.className = "citations";
      cite.textContent = "Sources: " + data.citations.map((c) => c.doc_id).join(", ");
      bubble.appendChild(cite);
    }
    setSuggestions(data.suggestions);
    loadSessions();
    es.close();
  });
  es.addEventListener("error", () => {
    if (!bubble.textContent) bubble.textContent = "(unavailable — try again)";
    es.close();
  });
}

document.getElementById("composer").onsubmit = (e) => { e.preventDefault(); send(); };
document.getElementById("newChat").onclick = () => {
  sessionId = null;
  localStorage.removeItem("rag_session");
  messagesEl.innerHTML = "";
  setSuggestions([]);
  loadSessions();
};
document.getElementById("clearChat").onclick = async () => {
  if (sessionId) await fetch(`/chat/clear/${sessionId}`, { method: "DELETE" });
  messagesEl.innerHTML = "";
  loadSessions();
};

loadSessions();
if (sessionId) loadHistory(sessionId);
