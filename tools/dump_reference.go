// dump_reference.go — conformance-vector dumper for the Go reference
// implementation (sachaservan/bgn).
//
// Run it next to a checkout of the reference with GMP + PBC installed
// (see the reference README for install steps):
//
//	cd /path/to/sachaservan/bgn
//	mkdir -p tools && cp /path/to/this/file tools/
//	go run tools/dump_reference.go > vectors.json
//
// then drop vectors.json into this repo's tests/vectors/reference/ and run
//
//	python -m pytest tests/test_interop.py -q
//
// The Python side (bgn_jax/interop/reference.py) imports the key material,
// re-encrypts every vector with the same randomness, and asserts identical
// pbc element bytes — the bit-exact conformance channel of SURVEY.md §4.
//
// This file has no Go module of its own on purpose: it compiles inside the
// reference repo's module (package main under tools/ with `go run`).
package main

import (
	"encoding/base64"
	"encoding/hex"
	"encoding/json"
	"fmt"
	"math/big"
	"os"

	"github.com/sachaservan/bgn"
)

const (
	keyBits     = 512
	msgSpace    = 1021 // bgn_test.go:8-13 constants
	polyBase    = 3
	fpScaleBase = 3
	fpPrecision = 0.0001
)

type ctVector struct {
	M         string `json:"m"`           // plaintext (decimal, may be negative)
	R         string `json:"r"`           // randomness (hex)
	L2        bool   `json:"l2"`          //
	BytesHex  string `json:"bytes_hex"`   // pbc Element.Bytes of C
	GobBase64 string `json:"gob_base64"`  // reference Ciphertext.Bytes()
	Decrypted string `json:"decrypted"`   // DecryptFailSafe result
}

type opVector struct {
	Op       string `json:"op"`        // add | mult | mult_const | neg | make_l2
	A        int    `json:"a"`         // index into ciphertexts
	B        int    `json:"b"`         // second index or constant
	L2       bool   `json:"l2"`        // result level
	BytesHex string `json:"bytes_hex"` // pbc Element.Bytes of the result
}

type dump struct {
	KeyBits       int        `json:"key_bits"`
	MsgSpace      int        `json:"msg_space"`
	PolyBase      int        `json:"poly_base"`
	FPScaleBase   int        `json:"fp_scale_base"`
	FPPrecision   float64    `json:"fp_precision"`
	PairingParams string     `json:"pairing_params"`
	N             string     `json:"n"`  // hex
	Q1            string     `json:"q1"` // hex (sk.Key)
	Q2            string     `json:"q2"` // hex (n / q1)
	R             string     `json:"r"`  // hex (sk.R)
	PHex          string     `json:"p_bytes_hex"`
	QHex          string     `json:"q_bytes_hex"`
	GTGenHex      string     `json:"gt_gen_bytes_hex"` // e(P, P)
	PublicKeyGob  string     `json:"public_key_gob"`   // base64 MarshalBinary
	Ciphertexts   []ctVector `json:"ciphertexts"`
	Ops           []opVector `json:"ops"`
}

func must(err error) {
	if err != nil {
		panic(err)
	}
}

func main() {
	pk, sk, err := bgn.NewKeyGen(keyBits, big.NewInt(msgSpace),
		polyBase, fpScaleBase, fpPrecision, true /* deterministic */)
	must(err)
	bgn.ComputeDecryptionPreprocessing(pk, sk)

	pkBytes, err := pk.MarshalBinary()
	must(err)

	d := dump{
		KeyBits:       keyBits,
		MsgSpace:      msgSpace,
		PolyBase:      polyBase,
		FPScaleBase:   fpScaleBase,
		FPPrecision:   fpPrecision,
		PairingParams: pk.PairingParams,
		N:             pk.N.Text(16),
		Q1:            sk.Key.Text(16),
		Q2:            new(big.Int).Div(pk.N, sk.Key).Text(16),
		R:             sk.R.Text(16),
		PHex:          hex.EncodeToString(pk.P.Bytes()),
		QHex:          hex.EncodeToString(pk.Q.Bytes()),
		PublicKeyGob:  base64.StdEncoding.EncodeToString(pkBytes),
	}

	gtGen := pk.Pairing.NewGT().NewFieldElement()
	gtGen.Pair(pk.P, pk.P)
	d.GTGenHex = hex.EncodeToString(gtGen.Bytes())

	// fixed (m, r) encryption vectors; r values are arbitrary but fixed
	ms := []int64{0, 1, 2, 510, 1020, 7, 123}
	cts := make([]*bgn.Ciphertext, 0, len(ms))
	for i, m := range ms {
		r := new(big.Int).Exp(big.NewInt(1000003), big.NewInt(int64(i+1)), pk.N)
		ct := pk.EncryptWithRandomness(big.NewInt(m), r)
		blob, err := ct.Bytes()
		must(err)
		dec := sk.DecryptFailSafe(ct, pk)
		d.Ciphertexts = append(d.Ciphertexts, ctVector{
			M:         big.NewInt(m).String(),
			R:         r.Text(16),
			L2:        ct.L2,
			BytesHex:  hex.EncodeToString(ct.C.Bytes()),
			GobBase64: base64.StdEncoding.EncodeToString(blob),
			Decrypted: dec.String(),
		})
		cts = append(cts, ct)
	}

	// deterministic homomorphic ops over the vectors
	record := func(op string, a, b int, ct *bgn.Ciphertext) {
		d.Ops = append(d.Ops, opVector{
			Op: op, A: a, B: b, L2: ct.L2,
			BytesHex: hex.EncodeToString(ct.C.Bytes()),
		})
	}
	record("add", 1, 2, pk.Add(cts[1], cts[2]))
	record("add", 3, 4, pk.Add(cts[3], cts[4]))
	record("mult", 1, 2, pk.Mult(cts[1], cts[2]))
	record("mult", 5, 6, pk.Mult(cts[5], cts[6]))
	record("mult_const", 5, 9, pk.MultConst(cts[5], big.NewInt(9)))
	record("neg", 6, 0, pk.Neg(cts[6]))
	record("make_l2_add", 1, 2, pk.Add(pk.Mult(cts[1], cts[2]), cts[3]))

	enc := json.NewEncoder(os.Stdout)
	enc.SetIndent("", " ")
	must(enc.Encode(d))
	fmt.Fprintln(os.Stderr, "vectors written to stdout")
}
