"""The pinned known-answer film (tests/golden/known_answer_film.npy),
reproduced through the CPU route: jitted LBVH build, accel/traverse.py,
wavefront engine, MIS."""

from henjou.runtime.known_answer import (
    RMSE_TOL,
    known_answer_rmse,
    render_known_answer_film,
)


def test_known_answer_film_on_cpu():
    film = render_known_answer_film()
    assert film.shape == (256, 3)
    assert known_answer_rmse(film) <= RMSE_TOL
