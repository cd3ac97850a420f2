"""``run(coro)``: the port's tests run their coroutines through it, never
through ``asyncio.run``.

``asyncio.run`` ends by setting the calling thread's event loop to None,
after which ``asyncio.get_event_loop()`` raises in the main thread on
Python 3.12, so a test file that ran after one in the same process (the
JAX package's ``tests/test_serve.py``, whose tests take the current loop)
failed.  This runs the coroutine on a loop of its own and closes it,
leaving the thread's event loop as it was.
"""

import asyncio


def run(coro):
    """Run ``coro`` to its end on a new event loop and close that loop;
    the thread's current event loop is never set."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        try:
            loop.run_until_complete(loop.shutdown_asyncgens())
        finally:
            loop.close()
