"""Unique names for the variables, parameters and layers of a Program.

The port's own copy of paddle_tpu/unique_name.py (``UniqueNameGenerator``
and ``guard``): the same keys give the same names in both packages, so a
program built by each under a fresh :func:`guard` names its variables
alike. Build-time only.
"""
import contextlib

__all__ = ['generate', 'switch', 'guard']


class UniqueNameGenerator(object):
    def __init__(self, prefix=None):
        self.ids = {}
        self.prefix = prefix or ''

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    if new_generator is None:
        generator = UniqueNameGenerator()
    else:
        generator = new_generator
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
