"""The chat web UI (port of exllama_tpu/webui/)."""
