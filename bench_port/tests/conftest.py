def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips on the CPU")
