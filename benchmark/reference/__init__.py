"""The plain reference: plain PyTorch, importing nothing of the port.

It works out again what the port derives from the benchmark's inputs
(the seeded weights and token ids): the RoBERTa-dot encoder and head in
fp32 (``encoder.py``), and the exact search and the negative mining
(``search.py``).
"""
