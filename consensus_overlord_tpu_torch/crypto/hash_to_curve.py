"""RFC 9380 hash-to-curve for BLS12-381 G1:
BLS12381G1_XMD:SHA-256_SSWU_RO_ (§8.8.1).

The reference signs via blst's hash-to-curve (reference
src/consensus.rs:390-395, through ophelia-blst); round 1/2 of this
rebuild used try-and-increment hashing, which is capability-equivalent
but not byte-interoperable with any standards-conformant BLS stack.
This module is the standards path: expand_message_xmd(SHA-256) →
hash_to_field(m=1, L=64) → simplified SWU on the 11-isogenous curve
E': y² = x³ + A'x + B' (Z = 11) → 11-isogeny → clear cofactor.

The isogeny coefficients below are NOT transcribed from the RFC
appendix: they are derived from first principles by
scripts/derive_g1_isogeny.py (division polynomial → rational order-11
kernel → Vélu's formulas → isomorphism normalization pinned by the
RFC's k_(1,0)), and verified structurally (image on E, homomorphism)
plus by the RFC known-answer vectors in tests/test_hash_to_curve.py.
Regenerate with: python scripts/derive_g1_isogeny.py

Host-side by design: hashing to the curve is O(1) per message per round
(one point for the common vote hash), while the O(N) work — per-vote
verification MSMs — lives on device (crypto/cuda_provider.py).

A copy of consensus_overlord_tpu/crypto/hash_to_curve.py: the PyTorch port
imports nothing of the JAX package, so it keeps its own.
"""

import hashlib
from typing import List, Optional, Tuple

P = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab", 16)

# Isogenous curve E' (RFC 9380 §8.8.1) and SWU constant Z = 11.
ISO_A = int(
    "144698a3b8e9433d693a02c96d4982b0ea985383ee66a8d8e8981aefd881ac98"
    "936f8da0e0f97f5cf428082d584c1d", 16)
ISO_B = int(
    "12e2908d11688030018b12e8753eee3b2016c1f0f24f4070a0b9c14fcef35ef5"
    "5a23215a316ceaa5d1cc48e98e172be0", 16)
SWU_Z = 11

#: G1 effective cofactor (RFC 9380 §8.8.1): 1 − z for the BLS12 parameter
#: z = −0xd201000000010000.
H_EFF = 0xD201000000010001

#: Default signing domain-separation tag when the deployment supplies no
#: common_ref (the reference hard-codes common_ref = "",
#: src/consensus.rs:351): the standard basic-scheme ciphersuite tag.
DEFAULT_DST = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"

# 11-isogeny E' → E rational maps (coefficients low-degree-first),
# derived by scripts/derive_g1_isogeny.py — see module docstring.
ISO_X_NUM = [
    0x11a05f2b1e833340b809101dd99815856b303e88a2d7005ff2627b56cdb4e2c85610c2d5f2e62d6eaeac1662734649b7,
    0x17294ed3e943ab2f0588bab22147a81c7c17e75b2f6a8417f565e33c70d1e86b4838f2a6f318c356e834eef1b3cb83bb,
    0x0d54005db97678ec1d1048c5d10a9a1bce032473295983e56878e501ec68e25c958c3e3d2a09729fe0179f9dac9edcb0,
    0x1778e7166fcc6db74e0609d307e55412d7f5e4656a8dbf25f1b33289f1b330835336e25ce3107193c5b388641d9b6861,
    0x0e99726a3199f4436642b4b3e4118e5499db995a1257fb3f086eeb65982fac18985a286f301e77c451154ce9ac8895d9,
    0x1630c3250d7313ff01d1201bf7a74ab5db3cb17dd952799b9ed3ab9097e68f90a0870d2dcae73d19cd13c1c66f652983,
    0x0d6ed6553fe44d296a3726c38ae652bfb11586264f0f8ce19008e218f9c86b2a8da25128c1052ecaddd7f225a139ed84,
    0x17b81e7701abdbe2e8743884d1117e53356de5ab275b4db1a682c62ef0f2753339b7c8f8c8f475af9ccb5618e3f0c88e,
    0x080d3cf1f9a78fc47b90b33563be990dc43b756ce79f5574a2c596c928c5d1de4fa295f296b74e956d71986a8497e317,
    0x169b1f8e1bcfa7c42e0c37515d138f22dd2ecb803a0c5c99676314baf4bb1b7fa3190b2edc0327797f241067be390c9e,
    0x10321da079ce07e272d8ec09d2565b0dfa7dccdde6787f96d50af36003b14866f69b771f8c285decca67df3f1605fb7b,
    0x06e08c248e260e70bd1e962381edee3d31d79d7e22c837bc23c0bf1bc24c6b68c24b1b80b64d391fa9c8ba2e8ba2d229,
]
ISO_X_DEN = [
    0x08ca8d548cff19ae18b2e62f4bd3fa6f01d5ef4ba35b48ba9c9588617fc8ac62b558d681be343df8993cf9fa40d21b1c,
    0x12561a5deb559c4348b4711298e536367041e8ca0cf0800c0126c2588c48bf5713daa8846cb026e9e5c8276ec82b3bff,
    0x0b2962fe57a3225e8137e629bff2991f6f89416f5a718cd1fca64e00b11aceacd6a3d0967c94fedcfcc239ba5cb83e19,
    0x03425581a58ae2fec83aafef7c40eb545b08243f16b1655154cca8abc28d6fd04976d5243eecf5c4130de8938dc62cd8,
    0x13a8e162022914a80a6f1d5f43e7a07dffdfc759a12062bb8d6b44e833b306da9bd29ba81f35781d539d395b3532a21e,
    0x0e7355f8e4e667b955390f7f0506c6e9395735e9ce9cad4d0a43bcef24b8982f7400d24bc4228f11c02df9a29f6304a5,
    0x0772caacf16936190f3e0c63e0596721570f5799af53a1894e2e073062aede9cea73b3538f0de06cec2574496ee84a3a,
    0x14a7ac2a9d64a8b230b3f5b074cf01996e7f63c21bca68a81996e1cdf9822c580fa5b9489d11e2d311f7d99bbdcc5a5e,
    0x0a10ecf6ada54f825e920b3dafc7a3cce07f8d1d7161366b74100da67f39883503826692abba43704776ec3a79a1d641,
    0x095fc13ab9e92ad4476d6e3eb3a56680f682b4ee96f7d03776df533978f31c1593174e4b4b7865002d6384d168ecdd0a,
    0x000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000001,
]
ISO_Y_NUM = [
    0x090d97c81ba24ee0259d1f094980dcfa11ad138e48a869522b52af6c956543d3cd0c7aee9b3ba3c2be9845719707bb33,
    0x134996a104ee5811d51036d776fb46831223e96c254f383d0f906343eb67ad34d6c56711962fa8bfe097e75a2e41c696,
    0x00cc786baa966e66f4a384c86a3b49942552e2d658a31ce2c344be4b91400da7d26d521628b00523b8dfe240c72de1f6,
    0x01f86376e8981c217898751ad8746757d42aa7b90eeb791c09e4a3ec03251cf9de405aba9ec61deca6355c77b0e5f4cb,
    0x08cc03fdefe0ff135caf4fe2a21529c4195536fbe3ce50b879833fd221351adc2ee7f8dc099040a841b6daecf2e8fedb,
    0x16603fca40634b6a2211e11db8f0a6a074a7d0d4afadb7bd76505c3d3ad5544e203f6326c95a807299b23ab13633a5f0,
    0x04ab0b9bcfac1bbcb2c977d027796b3ce75bb8ca2be184cb5231413c4d634f3747a87ac2460f415ec961f8855fe9d6f2,
    0x0987c8d5333ab86fde9926bd2ca6c674170a05bfe3bdd81ffd038da6c26c842642f64550fedfe935a15e4ca31870fb29,
    0x09fc4018bd96684be88c9e221e4da1bb8f3abd16679dc26c1e8b6e6a1f20cabe69d65201c78607a360370e577bdba587,
    0x0e1bba7a1186bdb5223abde7ada14a23c42a0ca7915af6fe06985e7ed1e4d43b9b3f7055dd4eba6f2bafaaebca731c30,
    0x19713e47937cd1be0dfd0b8f1d43fb93cd2fcbcb6caf493fd1183e416389e61031bf3a5cce3fbafce813711ad011c132,
    0x18b46a908f36f6deb918c143fed2edcc523559b8aaf0c2462e6bfe7f911f643249d9cdf41b44d606ce07c8a4d0074d8e,
    0x0b182cac101b9399d155096004f53f447aa7b12a3426b08ec02710e807b4633f06c851c1919211f20d4c04f00b971ef8,
    0x0245a394ad1eca9b72fc00ae7be315dc757b3b080d4c158013e6632d3c40659cc6cf90ad1c232a6442d9d3f5db980133,
    0x05c129645e44cf1102a159f748c4a3fc5e673d81d7e86568d9ab0f5d396a7ce46ba1049b6579afb7866b1e715475224b,
    0x15e6be4e990f03ce4ea50b3b42df2eb5cb181d8f84965a3957add4fa95af01b2b665027efec01c7704b456be69c8b604,
]
ISO_Y_DEN = [
    0x16112c4c3a9c98b252181140fad0eae9601a6de578980be6eec3232b5be72e7a07f3688ef60c206d01479253b03663c1,
    0x1962d75c2381201e1a0cbd6c43c348b885c84ff731c4d59ca4a10356f453e01f78a4260763529e3532f6102c2e49a03d,
    0x058df3306640da276faaae7d6e8eb15778c4855551ae7f310c35a5dd279cd2eca6757cd636f96f891e2538b53dbf67f2,
    0x16b7d288798e5395f20d23bf89edb4d1d115c5dbddbcd30e123da489e726af41727364f2c28297ada8d26d98445f5416,
    0x0be0e079545f43e4b00cc912f8228ddcc6d19c9f0f69bbb0542eda0fc9dec916a20b15dc0fd2ededda39142311a5001d,
    0x08d9e5297186db2d9fb266eaac783182b70152c65550d881c5ecd87b6f0f5a6449f38db9dfa9cce202c6477faaf9b7ac,
    0x166007c08a99db2fc3ba8734ace9824b5eecfdfa8d0cf8ef5dd365bc400a0051d5fa9c01a58b1fb93d1a1399126a775c,
    0x16a3ef08be3ea7ea03bcddfabba6ff6ee5a4375efa1f4fd7feb34fd206357132b920f5b00801dee460ee415a15812ed9,
    0x1866c8ed336c61231a1be54fd1d74cc4f9fb0ce4c6af5920abc5750c4bf39b4852cfe2f7bb9248836b233d9d55535d4a,
    0x167a55cda70a6e1cea820597d94a84903216f763e13d87bb5308592e7ea7d4fbc7385ea3d529b35e346ef48bb8913f55,
    0x04d2f259eea405bd48f010a01ad2911d9c6dd039bb61a6290e591b36e636a5c871a5c29f4f83060400f8b49cba8f6aa8,
    0x0accbb67481d033ff5852c1e48c50c477f94ff8aefce42d28c0f9a88cea7913516f968986f7ebbea9684b529e2561092,
    0x0ad6b9514c767fe3c3613144b45f1496543346d98adf02267d5ceef9a00d9b8693000763e3b90ac11e99b138573345cc,
    0x02660400eb2e4f3b628bdd0d53cd76f2bf565b94e72927c1cb748df27942480e420517bd8714cc80d1fadc1326ed06f7,
    0x0e0fa1d816ddc03e6b24255e0d7819c171c40f65e273b853324efcd6356caa205ca2f570f13497804415473a1d634b8f,
    0x000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000000001,
]


# ---------------------------------------------------------------------------
# expand_message_xmd (RFC 9380 §5.3.1, SHA-256)
# ---------------------------------------------------------------------------

def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // 32)
    assert ell <= 255 and len_in_bytes <= 65535
    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(
        b"\x00" * 64 + msg + len_in_bytes.to_bytes(2, "big") + b"\x00"
        + dst_prime).digest()
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [bi]
    for i in range(2, ell + 1):
        bi = hashlib.sha256(bytes(a ^ b for a, b in zip(b0, bi))
                            + bytes([i]) + dst_prime).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


def hash_to_field(msg: bytes, dst: bytes, count: int) -> List[int]:
    """count elements of Fp (m = 1, L = 64, RFC 9380 §5.2)."""
    uniform = expand_message_xmd(msg, dst, count * 64)
    return [int.from_bytes(uniform[i * 64:(i + 1) * 64], "big") % P
            for i in range(count)]


# ---------------------------------------------------------------------------
# Simplified SWU on E' + 11-isogeny to E (§6.6.2, §6.6.3)
# ---------------------------------------------------------------------------

def _sqrt(v: int) -> Optional[int]:
    r = pow(v, (P + 1) // 4, P)
    return r if r * r % P == v else None


def _sgn0(v: int) -> int:
    return v & 1


def map_to_curve_sswu(u: int) -> Tuple[int, int]:
    """u → a point on E' (never the identity)."""
    a, b, z = ISO_A, ISO_B, SWU_Z
    u2 = u * u % P
    tv1 = (z * z % P * (u2 * u2 % P) + z * u2) % P
    if tv1 == 0:
        x1 = b * pow(z * a % P, P - 2, P) % P
    else:
        x1 = (-b) % P * pow(a, P - 2, P) % P * (1 + pow(tv1, P - 2, P)) % P
    gx1 = (pow(x1, 3, P) + a * x1 + b) % P
    y = _sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = z * u2 % P * x1 % P
        gx2 = (pow(x, 3, P) + a * x + b) % P
        y = _sqrt(gx2)
        assert y is not None, "SWU: neither g(x1) nor g(x2) is square"
    if _sgn0(u) != _sgn0(y):
        y = (-y) % P
    return (x, y)


def _horner(coeffs: List[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def iso_map(pt: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """The 11-isogeny E' → E; None (identity) at kernel points."""
    x, y = pt
    den = _horner(ISO_X_DEN, x)
    if den == 0:
        return None
    xo = _horner(ISO_X_NUM, x) * pow(den, P - 2, P) % P
    yo = y * _horner(ISO_Y_NUM, x) % P * pow(_horner(ISO_Y_DEN, x),
                                             P - 2, P) % P
    return (xo, yo)


def hash_to_curve_g1(msg: bytes, dst: bytes = DEFAULT_DST
                     ) -> Tuple[int, int]:
    """BLS12381G1_XMD:SHA-256_SSWU_RO_ (uniform encoding, two SWU maps).
    The two E' points add on E' and map through ONE isogeny evaluation —
    identical to mapping separately (the isogeny is a homomorphism,
    verified by scripts/derive_g1_isogeny.py) but half the iso cost."""
    from . import bls12381 as oracle  # lazy: avoid import cycle

    u0, u1 = hash_to_field(msg, dst, 2)
    q0 = map_to_curve_sswu(u0)
    q1 = map_to_curve_sswu(u1)
    r = _add_on_iso(q0, q1)
    pt = iso_map(r) if r is not None else None
    return oracle.g1_mul(pt, H_EFF)


def _add_on_iso(p1, p2):
    """Affine addition on E' (a = ISO_A): O(1) host arithmetic."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1 + ISO_A) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)
