"""The paper's applications on the port (AES, paper §5.3)."""
