"""The paper's applications on the port (AES, paper §5.3; ResNet-20,
§5.1 and §7.5; the LLM encoder with I-BERT, §5.2)."""
