"""Tests for the quantum-object layer (Qobj, Operator, Channel, Basis,
measurements) including parity with the reference."""

import numpy as np
import pytest

import quantpy_tpu as qt
from quantpy_tpu import operator as op
from quantpy_tpu.channel import (
    amplitude_damping,
    dephasing,
    depolarize,
    depolarizing,
    walsh_hadamard,
)

from .reference_shim import get_reference

ref = get_reference()
needs_ref = pytest.mark.skipif(ref is None, reason="reference unavailable")


# ---------------------------------------------------------------- Qobj


def test_qobj_from_bloch_and_back():
    q = qt.Qobj([0.5, 0, 0, 0.5])
    np.testing.assert_allclose(q.matrix, [[1, 0], [0, 0]], atol=1e-12)
    q2 = qt.Qobj(q.matrix)
    np.testing.assert_allclose(q2.bloch, [0.5, 0, 0, 0.5], atol=1e-12)


def test_qobj_from_ket():
    q = qt.Qobj([1, 0], is_ket=True)
    np.testing.assert_allclose(q.matrix, [[1, 0], [0, 0]], atol=1e-12)
    assert q.is_pure()
    np.testing.assert_allclose(np.abs(q.ket()), [1, 0], atol=1e-10)


def test_qobj_padded_bloch():
    # 1-D input of non-4^k length is padded into a unit-trace bloch vector
    # (reference quantpy/qobj.py:91-98)
    q = qt.Qobj([0.1, 0.2, 0.3])
    assert q.n_qubits == 1
    np.testing.assert_allclose(q.bloch, [0.5, 0.1, 0.2, 0.3])


@needs_ref
def test_qobj_parity(rng):
    a = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    rho = a @ a.conj().T
    rho /= np.trace(rho)
    ours, theirs = qt.Qobj(rho), ref.Qobj(rho)
    np.testing.assert_allclose(ours.bloch, theirs.bloch, atol=1e-12)
    np.testing.assert_allclose(
        ours.ptrace((0,)).matrix, theirs.ptrace((0,)).matrix, atol=1e-12
    )
    np.testing.assert_allclose(ours.impurity(), theirs.impurity(), atol=1e-12)
    assert ours.is_density_matrix() == theirs.is_density_matrix()
    # algebra
    np.testing.assert_allclose((ours * 2 - ours).matrix, theirs.matrix, atol=1e-12)
    np.testing.assert_allclose(
        ours.kron(ours).matrix, theirs.kron(theirs).matrix, atol=1e-12
    )


def test_qobj_factories():
    assert qt.fully_mixed(2).trace() == pytest.approx(1)
    g = qt.GHZ(3)
    assert g.is_pure()
    assert qt.zero(2).matrix[0, 0] == 1
    # schmidt of a 2-qubit bell state: two equal singular values
    bell = qt.Qobj(np.array([1, 0, 0, 1]) / np.sqrt(2), is_ket=True)
    _, s, _ = bell.schmidt()
    np.testing.assert_allclose(s, [1 / np.sqrt(2)] * 2, atol=1e-10)


def test_qobj_latex_smoke():
    assert "array" in qt.fully_mixed(1)._repr_latex_()
    assert "vdots" in qt.fully_mixed(4)._repr_latex_()  # truncated 16x16


# ---------------------------------------------------------------- Operator


@needs_ref
def test_gate_library_parity():
    pairs = [
        (op.Id, "Id"), (op.X, "X"), (op.Y, "Y"), (op.Z, "Z"), (op.H, "H"),
        (op.T, "T"), (op.S, "S"), (op.CNOT, "CNOT"), (op.CY, "CY"),
        (op.CZ, "CZ"), (op.SWAP, "SWAP"), (op.ISWAP, "ISWAP"), (op.MS, "MS"),
        (op.Toffoli, "Toffoli"), (op.Fredkin, "Fredkin"),
    ]
    for ours, name in pairs:
        theirs = getattr(ref.operator, name)
        np.testing.assert_allclose(ours.matrix, theirs.matrix, atol=1e-12, err_msg=name)
    for theta in [0.3, np.pi / 2, -1.1]:
        for gate in ["PHASE", "RX", "RY", "RZ"]:
            np.testing.assert_allclose(
                getattr(op, gate)(theta).matrix,
                getattr(ref.operator, gate)(theta).matrix,
                atol=1e-12,
                err_msg=f"{gate}({theta})",
            )


def test_operator_transform():
    psi = qt.zero(1)
    flipped = op.X.transform(psi)
    np.testing.assert_allclose(flipped.matrix, [[0, 0], [0, 1]], atol=1e-12)
    assert qt.join_gates([op.H, op.Z, op.H]).matrix == pytest.approx(op.X.matrix)


# ---------------------------------------------------------------- Channel


def test_channel_representations_consistent():
    ch = depolarizing(0.3)
    choi = ch.choi
    # rebuild from choi and from kraus; all three transform identically
    ch_choi = qt.Channel(choi)
    ch_kraus = qt.Channel([k.matrix for k in ch_choi.kraus])
    rho = qt.Qobj(np.array([[0.7, 0.2 + 0.1j], [0.2 - 0.1j, 0.3]]))
    out_f = ch.transform(rho).matrix
    np.testing.assert_allclose(ch_choi.transform(rho).matrix, out_f, atol=1e-10)
    np.testing.assert_allclose(ch_kraus.transform(rho).matrix, out_f, atol=1e-10)


@needs_ref
def test_channel_parity_with_reference(rng):
    ours_list = [
        (depolarizing(0.25), ref.channel.depolarizing(0.25)),
        (dephasing(0.4), ref.channel.dephasing(0.4)),
        (amplitude_damping(0.15), ref.channel.amplitude_damping(0.15)),
        (walsh_hadamard(2), ref.channel.walsh_hadamard(2)),
        (
            depolarize(amplitude_damping(0.3), 0.1),
            ref.channel.depolarize(ref.channel.amplitude_damping(0.3), 0.1),
        ),
    ]
    for ours, theirs in ours_list:
        np.testing.assert_allclose(
            ours.choi.matrix, theirs.choi.matrix, atol=1e-10
        )
        assert ours.is_cptp() and theirs.is_cptp()
        a = rng.normal(size=(2**ours.n_qubits,) * 2)
        rho = a @ a.T
        rho = rho / np.trace(rho)
        np.testing.assert_allclose(
            ours.transform(qt.Qobj(rho)).matrix,
            theirs.transform(ref.Qobj(rho)).matrix,
            atol=1e-10,
        )


def test_channel_kraus_roundtrip():
    ch = amplitude_damping(0.2)
    kr = ch.kraus
    # completeness: sum K^H K = I
    acc = sum(k.matrix.conj().T @ k.matrix for k in kr)
    np.testing.assert_allclose(acc, np.eye(2), atol=1e-10)


def test_channel_algebra():
    a = depolarizing(0.5)
    b = dephasing(0.5)
    s = a + b
    np.testing.assert_allclose(
        s.choi.matrix, a.choi.matrix + b.choi.matrix, atol=1e-10
    )
    np.testing.assert_allclose((a * 2).choi.matrix, a.choi.matrix * 2, atol=1e-12)
    assert a.H.choi.matrix == pytest.approx(a.choi.matrix.conj().T)


def test_channel_composition():
    """`a @ b` is map composition: unitary channels compose
    like their operators, mixed-representation pairs compose through
    transform, and the result is CPTP."""
    # unitary test: U.as_channel() @ V.as_channel() == (U @ V).as_channel()
    u, v = op.H, op.T
    composed = u.as_channel() @ v.as_channel()
    direct = (u @ v).as_channel()
    np.testing.assert_allclose(
        composed.choi.matrix, direct.choi.matrix, atol=1e-10
    )
    # kraus-kraus pairing takes the Kraus-chain branch
    a = amplitude_damping(0.2)
    b = amplitude_damping(0.3)
    ab = a @ b
    assert ab._kraus is not None and len(ab._kraus) == 4
    rho = qt.Qobj(np.array([[0.7, 0.2 + 0.1j], [0.2 - 0.1j, 0.3]]))
    np.testing.assert_allclose(
        ab.transform(rho).matrix,
        a.transform(b.transform(rho)).matrix,
        atol=1e-12,
    )
    assert ab.is_cptp()
    # functional x kraus pairing composes lazily, same action
    c = depolarizing(0.5)
    ca = c @ a
    np.testing.assert_allclose(
        ca.transform(rho).matrix,
        c.transform(a.transform(rho)).matrix,
        atol=1e-12,
    )
    assert ca.is_cptp()
    # composition is order-sensitive
    ac = a @ c
    assert not np.allclose(ac.choi.matrix, ca.choi.matrix)
    # mismatched sizes / non-channels are rejected
    with pytest.raises(ValueError):
        depolarizing(0.5, 2) @ a
    with pytest.raises(TypeError):
        a @ op.H


def test_unitary_as_channel():
    ch = op.X.as_channel()
    rho = qt.zero(1)
    np.testing.assert_allclose(
        ch.transform(rho).matrix, [[0, 0], [0, 1]], atol=1e-12
    )
    assert ch.is_cptp()


# ---------------------------------------------------------------- Basis


@needs_ref
def test_basis_parity(rng):
    elements = [qt.Qobj(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))
                for _ in range(4)]
    ref_elements = [ref.Qobj(e.matrix) for e in elements]
    ours = qt.Basis(elements)
    theirs = ref.basis.Basis(ref_elements)
    np.testing.assert_allclose(ours.gram, theirs.gram, atol=1e-12)
    target = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    c_ours = ours.decompose(qt.Qobj(target))
    c_theirs = theirs.decompose(ref.Qobj(target))
    np.testing.assert_allclose(c_ours, c_theirs, atol=1e-10)
    np.testing.assert_allclose(
        ours.compose(c_ours).matrix, target, atol=1e-10
    )


def test_basis_decompose_batch(rng):
    elements = [qt.Qobj(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))
                for _ in range(16)]
    basis = qt.Basis(elements)
    targets = rng.normal(size=(5, 4, 4)) + 1j * rng.normal(size=(5, 4, 4))
    batch = basis.decompose_batch(targets)
    assert batch.shape == (5, 16)
    for k in range(5):
        np.testing.assert_allclose(
            batch[k], basis.decompose(targets[k]), atol=1e-10
        )


# ---------------------------------------------------------------- POVMs


@needs_ref
@pytest.mark.parametrize("preset", ["proj", "proj-set", "proj4", "sic"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_povm_parity(preset, n):
    ours = qt.generate_measurement_matrix(preset, n)
    theirs = ref.generate_measurement_matrix(preset, n)
    np.testing.assert_allclose(ours, theirs, atol=1e-12)


def test_povm_rows_sum_to_identity():
    # each measurement POVM's outcome rows sum to the identity bloch vector
    # [1, 0, ..., 0] (proj4 is an input-*state* set and doesn't satisfy this)
    for preset in ["proj", "proj-set", "sic"]:
        m = qt.generate_measurement_matrix(preset, 2)
        per_povm = m.sum(axis=1)
        expected = np.zeros(16)
        expected[0] = 1.0
        np.testing.assert_allclose(
            per_povm, np.broadcast_to(expected, per_povm.shape), atol=1e-12,
            err_msg=preset,
        )


def test_povm_array_passthrough(rng):
    full = rng.normal(size=(5, 16))
    out = qt.generate_measurement_matrix(full, 2)
    assert out.shape == (1, 5, 16)
    perq = rng.normal(size=(2, 4))
    out = qt.generate_measurement_matrix(perq, 2)
    assert out.shape == (1, 4, 16)
    np.testing.assert_allclose(out[0], np.kron(perq[None], perq[None])[0])


def test_qobj_setter_invalidation():
    q = qt.Qobj(np.array([0.5, 0.5, 0, 0]))
    m1 = q.matrix.copy()
    q.bloch = np.array([0.5, 0, 0, 0.5])  # must invalidate cached matrix
    np.testing.assert_allclose(q.matrix, [[1, 0], [0, 0]], atol=1e-12)
    assert not np.allclose(q.matrix, m1)
    q.matrix = np.eye(2) / 2  # must invalidate cached bloch
    np.testing.assert_allclose(q.bloch, [0.5, 0, 0, 0], atol=1e-12)


def test_channel_setters():
    ch = depolarizing(0.5)
    choi0 = ch.choi.matrix.copy()
    # kraus setter resets choi
    ch.kraus = [np.eye(2)]
    np.testing.assert_allclose(
        ch.choi.matrix,
        np.kron(np.eye(2), np.eye(2)).reshape(4, 4) * 0
        + qt.Channel([np.eye(2)]).choi.matrix,
        atol=1e-12,
    )
    assert not np.allclose(ch.choi.matrix, choi0)
    # set_func resets both
    ch.set_func(lambda rho: rho, 1)
    np.testing.assert_allclose(
        ch.choi.matrix, qt.Channel([np.eye(2)]).choi.matrix, atol=1e-12
    )
    # choi setter
    ch2 = depolarizing(0.3)
    ch.choi = ch2.choi
    np.testing.assert_allclose(ch.choi.matrix, ch2.choi.matrix)
