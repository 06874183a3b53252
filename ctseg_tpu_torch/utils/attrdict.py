"""Dictionary with attribute-style access (reference capstone/utils/utils.py:1-18)."""


class AttrDict(dict):
    """dict whose items are also reachable as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e
