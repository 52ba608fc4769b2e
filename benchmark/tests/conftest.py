"""The harness's tests: on the CPU at tiny sizes; ``card`` tests need the
H100 and skip without one (decided inside each test).

    python3 -m pytest benchmark/tests -q            # here, the card tests skip
    python3 -m pytest benchmark/tests -q -m card    # on the card
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
